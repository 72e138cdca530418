"""The LM families' ShardSpec trees and ``constrain`` hooks against the JAX
package, on the CPU, one process.

- ``Model.param_specs()`` equals the reference's spec tree
  (``build_model(cfg).init(key)[1]``) leaf for leaf, for every arch of
  the registry at reduced width, once the reference's layout is mapped to
  the port's: stacked layers (a leading ``"layers"`` axis) and
  ``layer_i`` dicts become a list with one tree a layer, ``"layers"``
  removed. Every ShardSpec names one axis per dim of its param.
- ``state_logical_axes`` equals the reference's.
- ``forward``, ``prefill`` and ``decode_step`` with a ``constrain`` that
  returns its input and records its calls give the bits of the calls
  without one, and call it wherever the reference's forward calls it,
  in order (recorded the same way, eagerly), plus the port's own hooks:
  ``("batch", None, None)`` where a mixer or an MLP needs the whole
  sequence, and a mixer's output placed before the residual add.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch.train import extras_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.nn.init import ShardSpec  # noqa: E402

LAYER_KEYS = {"blocks": "n_layers", "encoder": "n_enc_layers", "decoder": "n_layers"}
# the hook the port adds: a mixer's input with ``seq`` gathered
GATHER = ("batch", None, None)


def _axes(tree):
    """A spec tree with every ShardSpec (either package's) as its axes."""
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_axes(v) for v in tree]
    return tuple(tree.axes)


def _port_layout(ref_specs, cfg):
    """The reference's spec tree in the port's layout."""
    out = {}
    for k, v in ref_specs.items():
        if k not in LAYER_KEYS:
            out[k] = _axes(v)
            continue
        n = getattr(cfg, LAYER_KEYS[k])
        if "layer_0" in v:
            out[k] = [_axes(v[f"layer_{i}"]) for i in range(n)]
        else:
            def strip(s):
                if isinstance(s, dict):
                    return {kk: strip(vv) for kk, vv in s.items()}
                assert s.axes[0] == "layers", s
                return tuple(s.axes[1:])
            out[k] = [strip(v) for _ in range(n)]
    return out


def _paired(specs, params, path=""):
    if isinstance(specs, dict):
        assert sorted(specs) == sorted(params), path
        for k in specs:
            yield from _paired(specs[k], params[k], f"{path}/{k}")
    elif isinstance(specs, list):
        assert len(specs) == len(params), path
        for i, (s, p) in enumerate(zip(specs, params)):
            yield from _paired(s, p, f"{path}#{i}")
    else:
        yield path, specs, params


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference_tree(arch):
    cfg = reduced(ARCHS[arch])
    _, ref_specs = ref_build_model(ref_reduced(REF_ARCHS[arch])).init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    specs = model.param_specs()
    assert _axes(specs) == _port_layout(ref_specs, cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pairs = list(_paired(specs, params))
    assert len(pairs) == len(list(tree_leaves(params)))
    for path, spec, p in pairs:
        assert isinstance(spec, ShardSpec) and len(spec.axes) == p.ndim, (path, spec, p.shape)
    layers = model.layer_specs()
    if cfg.family == "encdec":
        assert layers == {"encoder": specs["encoder"], "decoder": specs["decoder"]}
    else:
        assert layers == specs["blocks"]


def test_state_logical_axes_equal_the_reference():
    for arch in ("tinyllama-1.1b", "mixtral-8x7b"):
        cfg = reduced(ARCHS[arch])
        assert _axes(lm.state_logical_axes(cfg)) == _axes(
            ref_lm.state_logical_axes(ref_reduced(REF_ARCHS[arch])))


class Recorder:
    """A constrain that returns its input and records the logical axes it
    was called with."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, axes):
        self.calls.append(tuple(axes))
        return x


def _batch(cfg, B=2, T=12, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    batch.update({k: np.asarray(f(B, T)) for k, f in extras_for(cfg).items()})
    return batch


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# one arch a family (gemma3-4b for the sandwich norms and local layers)
FAMILY_ARCHS = ("tinyllama-1.1b", "gemma3-4b", "mixtral-8x7b", "qwen2-vl-72b",
                "recurrentgemma-2b", "whisper-large-v3", "rwkv6-1.6b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_constrain_changes_no_bits_and_hooks_where_the_reference_does(arch):
    """f32 at reduced width, remat on (the hooks run inside the remat'd
    layers); the reference runs eagerly, without remat (``jax.checkpoint``
    reuses a layer's trace) and with its layers unscanned where its config
    allows it, so each layer's hooks are recorded."""
    cfg = reduced(ARCHS[arch], dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu", masters=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

    rec = Recorder()
    got, _ = model.forward(params, batch, constrain=rec, layer_specs=model.layer_specs())
    want, _ = model.forward(params, batch)
    assert torch.equal(got, want)
    with torch.no_grad():
        lg_rec, st_rec = model.prefill(params, batch, constrain=Recorder())
        lg, st = model.prefill(params, batch)
        assert torch.equal(lg_rec, lg) and _equal(st_rec, st)
        full_a = model.rehome_state(st, batch["tokens"].shape[1] + 2)
        full_b = model.rehome_state(st, batch["tokens"].shape[1] + 2)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        la, sa = model.decode_step(params, full_a, tok, constrain=Recorder())
        lb, sb = model.decode_step(params, full_b, tok)
        assert torch.equal(la, lb) and _equal(sa, sb)

    rcfg = ref_reduced(REF_ARCHS[arch], dtype="float32", remat="none")
    if rcfg.scan_layers and rcfg.family not in ("encdec", "rwkv"):
        rcfg = dataclasses.replace(rcfg, scan_layers=False)
    rm = ref_build_model(rcfg)
    rparams, _ = rm.init(jax.random.PRNGKey(2))
    ref_rec = Recorder()
    rm.forward(rparams, {k: jnp.asarray(v) for k, v in _batch(cfg).items()}, constrain=ref_rec)
    # the reference's hooks appear in the port's calls in order (all of
    # them: the scanned whisper and rwkv trace each scan's body once);
    # the port's own are the reference's kinds too (a mixer's or MLP's
    # output placed before the residual add), or ``seq`` gathered at a
    # mixer's or MLP's input
    assert ref_rec.calls, "the reference called no hook"
    it = iter(rec.calls)
    assert all(any(c == p for p in it) for c in ref_rec.calls)  # a subsequence
    assert set(rec.calls) <= set(ref_rec.calls) | {GATHER}
    assert GATHER in rec.calls
    if cfg.family not in ("encdec", "rwkv"):
        assert set(rec.calls) == set(ref_rec.calls) | {GATHER}
