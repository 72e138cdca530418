"""The port's LM training loop against the JAX package, on the CPU: two
steps of `make_train_step` at ``accum_steps`` 1 and 2 (against the
reference's scan and its unrolled form), the
error-feedback compressor, the token pipeline and straggler monitor
copies, and the launcher `repro_torch.launch.train` (resume, the
reference's checkpoints, the resume quirk, the example script).

Weights are the reference's ``init`` at reduced width in f32, crossed over
as numpy arrays into f32 masters; inputs come from numpy seeds or the
token pipeline. Tolerances: metrics within 1e-5 relative (one forward and
backward pass sums in another order than XLA's, ~1e-7 here); the first
Adam step's update within 1e-3 relative plus 4 f32 ulps of the param
where the gradient is above 1e-3 of its leaf's largest, and within 2 x lr
elsewhere (Adam divides by sqrt(v), so a near-zero gradient's last-bit
difference can move its first update by up to ~lr either way); the
compressor's int8 payload exactly, its scales and
residuals within 1e-7. The port against itself on the CPU is bit for bit.

The reference's own launcher (``repro.launch.train.train``) does not run
with the installed JAX: its step raises ``ShardingTypeError`` at the
embedding gather on its (data, model) mesh. The reference checkpoint below
is therefore written as that launcher writes it (``CheckpointManager.save``
of ``{"params", "opt"}`` after steps of the reference's ``make_train_step``
on its ``TokenLoader``'s batches), without the mesh.
"""
import dataclasses
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro.runtime import straggler as ref_straggler  # noqa: E402
from repro.training import compression as ref_compression  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_train_loop  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import straggler  # noqa: E402
from repro_torch.training import compression, optimizer, train_loop  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
METRIC_RTOL = 1e-5
LR = 1e-3
F32_ARCH = "tinyllama-f32"  # tinyllama-1.1b computing in f32, for the launcher


def configs(name):
    return (ref_reduced(REF_ARCHS[name], dtype="float32"),
            reduced(registry.ARCHS[name], dtype="float32"))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaf_pairs(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from leaf_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from leaf_pairs(x, y, f"{path}#{i}")
    else:
        yield path, a, b


def assert_trees_equal(a, b):
    for path, x, y in leaf_pairs(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("accum,unroll", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_train_step_matches_reference(arch, accum, unroll):
    """Two steps; ``unroll`` picks the reference's unrolled accumulation,
    which the port's one loop must equal as it equals the scan. After the
    first: the metrics, Adam's m, and each param's update (new - old),
    which is about lr x sign(g) where the gradient is large, so a missing
    or wrong-signed update fails. The second step's metrics depend on the
    first update."""
    rcfg, cfg = configs(arch)
    rm, model = ref_build_model(rcfg), build_model(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
                "loss_mask": (rng.random((4, 16)) < 0.8).astype(np.float32)} for _ in range(2)]
    ref_step = jax.jit(ref_train_loop.make_train_step(
        rm, ref_opt.AdamConfig(lr=LR), accum_steps=accum, accum_unroll=unroll))
    r_params, r_opt, r_metrics = ref_step(rparams, ref_opt.adam_init(rparams),
                                          {k: jnp.asarray(v) for k, v in batches[0].items()})

    params = model.params_from_numpy(np_tree(rparams), "cpu", masters=True)
    step = train_loop.make_train_step(model, optimizer.AdamConfig(lr=LR), accum_steps=accum)
    new_params, new_opt, metrics = step(params, optimizer.adam_init(params),
                                        {k: torch.from_numpy(v) for k, v in batches[0].items()})
    assert sorted(metrics) == sorted(r_metrics)
    assert ("moe_loss" in metrics) == (cfg.family == "moe")
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(r_metrics[k]), rtol=METRIC_RTOL, err_msg=k)
    assert int(new_opt["step"]) == int(r_opt["step"]) == 1
    want = model.params_from_numpy(np_tree(r_params), "cpu", masters=True)
    want_m = model.params_from_numpy(np_tree(r_opt["m"]), "cpu", masters=True)
    n_large = 0
    for (path, p, w), (_, m, wm), (_, old, _) in zip(leaf_pairs(new_params, want),
                                                      leaf_pairs(new_opt["m"], want_m),
                                                      leaf_pairs(params, params)):
        assert p.dtype == torch.float32 and not p.requires_grad, path
        assert float((m - wm).abs().max()) <= 1e-4 * float(wm.abs().max()) + 1e-8, path
        du, want_du = p - old, w - old
        large = wm.abs() > 1e-3 * float(wm.abs().max())  # m = (1 - b1) g after one step
        tol = 1e-3 * want_du.abs() + 4 * torch.finfo(torch.float32).eps * old.abs()
        bad = (du - want_du).abs() > tol
        assert not bool((bad & large).any()), (
            f"{path}: update off the reference's where the gradient is large, max |diff| "
            f"{float((du - want_du)[large].abs().max()):.3e}")
        d = float((p - w).abs().max())
        assert d <= 2 * LR, f"{path}: max |diff| {d:.3e} > 2 x lr"
        n_large += int(large.sum())
    assert n_large > 0
    _, _, r_metrics2 = ref_step(r_params, r_opt, {k: jnp.asarray(v) for k, v in batches[1].items()})
    _, _, metrics2 = step(new_params, new_opt, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    for k in metrics2:
        np.testing.assert_allclose(float(metrics2[k]), float(r_metrics2[k]), rtol=METRIC_RTOL,
                                   err_msg=f"step 2 {k}")


def _tree(rng):
    return {"w": (3 * rng.standard_normal((5, 7))).astype(np.float32),
            "blocks": [rng.standard_normal(11).astype(np.float32),
                       {"b": (1e-3 * rng.standard_normal((4, 3))).astype(np.float32)}]}


def test_error_feedback_compressor_matches_reference():
    """Two rounds (the second compresses with the first's residual): the
    int8 payload equal, scales and residuals within 1e-7."""
    rng = np.random.default_rng(6)
    rcomp, comp = ref_compression.ErrorFeedbackCompressor(8), compression.ErrorFeedbackCompressor(8)
    g1, g2 = _tree(rng), _tree(rng)
    r_resid = rcomp.init(jax.tree_util.tree_map(jnp.asarray, g1))
    p_resid = comp.init(jax.tree_util.tree_map(torch.from_numpy, g1))
    for g in (g1, g2):
        r_payload, r_resid = rcomp.compress(jax.tree_util.tree_map(jnp.asarray, g), r_resid)
        p_payload, p_resid = comp.compress(jax.tree_util.tree_map(torch.from_numpy, g), p_resid)
        # JAX flattens dicts in key order: blocks, then w; q, scale a leaf
        r_flat = jax.tree_util.tree_leaves(r_payload)
        p_flat = [t for pair in (p_payload["blocks"][0], p_payload["blocks"][1]["b"], p_payload["w"])
                  for t in pair]
        for i, (r, p) in enumerate(zip(r_flat, p_flat)):
            if i % 2 == 0:
                assert p.dtype == torch.int8
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))
            else:
                np.testing.assert_allclose(float(p), float(r), rtol=0, atol=1e-7)
        for r, p in zip(jax.tree_util.tree_leaves(r_resid),
                        [p_resid["blocks"][0], p_resid["blocks"][1]["b"], p_resid["w"]]):
            assert p.dtype == torch.float32
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-7)
        r_deq, p_deq = rcomp.decompress(r_payload), comp.decompress(p_payload)
        assert isinstance(p_deq["blocks"], list)
        np.testing.assert_allclose(p_deq["blocks"][1]["b"].numpy(), np.asarray(r_deq["blocks"][1]["b"]),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-72b"])
def test_token_loader_copy_gives_the_reference_batches(arch):
    """The copy's first batches equal the reference's array for array,
    extras included (whisper's frames; qwen2-vl's patches and M-RoPE
    positions), on a host shard too."""
    rcfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(registry.ARCHS[arch])
    for kw in ({}, {"host_id": 1, "n_hosts": 2, "seed": 3}):
        ref = ref_pipeline.TokenLoader(rcfg.vocab, 4, 24, extras=ref_train.extras_for(rcfg), **kw)
        port = pipeline.TokenLoader(cfg.vocab, 4, 24, extras=port_train.extras_for(cfg), **kw)
        try:
            for _ in range(3):
                a, b = next(ref), next(port)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        finally:
            ref.close()
            port.close()


def test_straggler_monitor_copy_gives_the_reference_actions():
    times = [0.1] * 10 + [0.5, 0.1, 0.45, 0.1]
    hosts = [{0: 0.1, 1: 0.1, 2: 0.9}] * 6 + [{0: 0.1, 1: 0.1, 2: 0.1}]
    ref, port = ref_straggler.StragglerMonitor(), straggler.StragglerMonitor()
    for i, t in enumerate(times):
        h = hosts[i] if i < len(hosts) else None
        assert port.record(i, t, h) == ref.record(i, t, h)
    assert port.events == ref.events and port.flags == ref.flags
    assert port.mean_step_time == ref.mean_step_time


def test_train_runs_on_the_cpu_and_refuses_what_it_cannot_do():
    res = port_train.train("tinyllama-1.1b", reduced=True, steps=3, batch=4, seq=32,
                           device="cpu", log_every=0)
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["final_loss"] == res["losses"][-1]
    assert [m["loss"] for m in res["metrics"]] == res["losses"]
    assert all(m["grad_norm"] > 0 for m in res["metrics"])
    assert len(res["monitor"].history) == 3
    assert int(res["opt"]["step"]) == 3
    # the reference's clamp: alone, model_axis 2 runs at model 1, the same run
    clamped = port_train.train("tinyllama-1.1b", reduced=True, steps=3, batch=4, seq=32,
                               model_axis=2, device="cpu", log_every=0)
    assert res["mesh"] == clamped["mesh"] == (1, 1)
    assert clamped["losses"] == res["losses"]
    if not torch.cuda.is_available():  # no fallback: the default is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            port_train.train("tinyllama-1.1b", steps=1)


class Recording(pipeline.TokenLoader):
    """A TokenLoader that keeps the batches it hands out."""

    seen = []

    def __next__(self):
        b = super().__next__()
        Recording.seen.append(b)
        return b


def test_resume_restores_state_bit_for_bit_and_restarts_the_data(tmp_path, monkeypatch):
    """Two steps and a checkpoint, then a run to step 4 resumed from it:
    the restored masters and Adam state are the saved ones bit for bit, in
    the port's structure; the resumed run trains on data steps 0 and 1
    again (the reference's quirk: its loader starts at 0 on every run),
    and its first step equals one train step from the saved state on data
    step 0, bit for bit."""
    monkeypatch.setattr(port_train, "TokenLoader", Recording)
    monkeypatch.setattr(Recording, "seen", [])
    kw = dict(reduced=True, batch=4, seq=32, ckpt_dir=str(tmp_path), device="cpu", log_every=0)
    first = port_train.train("tinyllama-1.1b", steps=2, **kw)
    first_batches = list(Recording.seen)
    cfg = registry.get_reduced_config("tinyllama-1.1b")
    model = build_model(cfg)
    params, opt, step = port_train.restore_state(CheckpointManager(tmp_path), model, "cpu",
                                                 first["params"])
    assert step == 2
    assert isinstance(params["blocks"], list)
    assert_trees_equal(params, first["params"])
    assert_trees_equal(opt, first["opt"])

    Recording.seen.clear()
    second = port_train.train("tinyllama-1.1b", steps=4, **kw)
    assert len(second["losses"]) == 2
    for a, b in zip(Recording.seen[:2], first_batches[:2]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    step_fn = train_loop.make_train_step(
        model, optimizer.AdamConfig(lr=3e-4, warmup_steps=1, decay_steps=4), accum_steps=cfg.accum_steps)
    b0 = {k: torch.from_numpy(v) for k, v in first_batches[0].items()}
    _, _, metrics = step_fn(params, opt, b0)
    assert float(metrics["loss"]) == second["losses"][0]
    assert int(second["opt"]["step"]) == 4


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint as the reference's launcher writes it (stacked layers,
    its Adam state after two steps) resumes in the port's launcher: the
    restored masters and Adam state equal the saved arrays, and the next
    step's loss equals the reference's next step on the same batch (data
    step 0 again, in both packages) within 1e-5."""
    base = dataclasses.replace(registry.ARCHS["tinyllama-1.1b"], dtype="float32")
    monkeypatch.setitem(registry.ARCHS, F32_ARCH, base)
    rcfg = ref_reduced(dataclasses.replace(REF_ARCHS["tinyllama-1.1b"], dtype="float32"))
    rm = ref_build_model(rcfg)
    steps, batch, seq = 3, 4, 32
    acfg = ref_opt.AdamConfig(lr=3e-4, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    ref_step = jax.jit(ref_train_loop.make_train_step(rm, acfg, accum_steps=rcfg.accum_steps))
    rparams, _ = rm.init(jax.random.PRNGKey(0))
    ropt = ref_opt.adam_init(rparams)
    loader = ref_pipeline.TokenLoader(rcfg.vocab, batch, seq, extras=ref_train.extras_for(rcfg))
    try:
        batches = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    for b in batches:
        rparams, ropt, _ = ref_step(rparams, ropt, b)
    RefCheckpointManager(tmp_path, keep=2).save(2, {"params": rparams, "opt": ropt})
    saved = {"params": np_tree(rparams), "opt": np_tree(ropt)}
    assert saved["params"]["blocks"]["attn"]["wq"].shape[0] == rcfg.n_layers  # stacked
    _, _, r_next = ref_step(rparams, ropt, batches[0])

    model = build_model(reduced(base))
    like = model.init(torch.Generator().manual_seed(0), device="cpu", masters=True)
    params, opt, step = port_train.restore_state(CheckpointManager(tmp_path), model, "cpu", like)
    assert step == 2
    assert_trees_equal(params, model.params_from_numpy(saved["params"], "cpu", masters=True))
    assert_trees_equal(opt["v"], model.params_from_numpy(saved["opt"]["v"], "cpu", masters=True))
    assert int(opt["step"]) == 2 and opt["step"].dtype == torch.int32
    res = port_train.train(F32_ARCH, reduced=True, steps=steps, batch=batch, seq=seq,
                           ckpt_dir=str(tmp_path), device="cpu", log_every=0)
    assert len(res["losses"]) == 1
    np.testing.assert_allclose(res["losses"][0], float(r_next["loss"]), rtol=1e-5)


def test_example_trains_the_tiny_config(tmp_path, capsys):
    mod = runpy.run_path(str(REPO / "examples" / "train_lm_torch.py"), run_name="example")
    mod["main"](["--tiny", "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "mean step time" in out
    assert CheckpointManager(tmp_path).latest_step() == 2
