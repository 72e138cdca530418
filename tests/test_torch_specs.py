"""``repro_torch.launch.specs`` against the JAX package's ``launch.specs``:
the decode state's logical axes, ShardSpec for ShardSpec, and its shapes
and dtypes (meta tensors, no storage, against ``jax.eval_shape``), for
every arch at ``decode_32k`` and ``long_500k``; the batch and token
stand-ins at every shape; the params' shapes and specs without drawing a
weight."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.nn.init import ShardSpec as RefShardSpec  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.nn.init import ShardSpec  # noqa: E402

DECODE_SHAPES = ("decode_32k", "long_500k")


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts (the reference's or the port's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _same_dtype(t, ref):
    return str(t.dtype).removeprefix("torch.") == np.dtype(ref.dtype).name


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_state_axes_and_shapes_equal_the_reference(arch, shape):
    ref_shapes = ref_specs.decode_state_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    want_axes = _flat(ref_specs.decode_state_axes(REF_ARCHS[arch], ref_shapes))
    got = specs.decode_state_specs(ARCHS[arch], SHAPES[shape])
    got_axes = _flat(specs.decode_state_axes(ARCHS[arch], got))
    assert got_axes.keys() == want_axes.keys()
    for k, s in got_axes.items():
        assert isinstance(s, ShardSpec) and isinstance(want_axes[k], RefShardSpec)
        assert tuple(s.axes) == tuple(want_axes[k].axes), k
    want, leaves = _flat(ref_shapes), _flat(got)
    assert leaves.keys() == want.keys()
    for k, t in leaves.items():
        assert tuple(t.shape) == tuple(want[k].shape) and _same_dtype(t, want[k]), k
        assert t.device.type == "meta", k  # a shape and a dtype, no storage
        assert len(got_axes[k].axes) == t.ndim, k


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_token_specs_equal_the_reference(arch, shape):
    want, want_axes = ref_specs.batch_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    got, got_axes = specs.batch_specs(ARCHS[arch], SHAPES[shape])
    assert got.keys() == want.keys() == got_axes.keys()
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape) and _same_dtype(t, want[k]), k
        assert t.device.type == "meta" and tuple(got_axes[k].axes) == tuple(want_axes[k].axes)
    tok, tok_axes = specs.decode_token_specs(ARCHS[arch], SHAPES[shape])
    ref_tok, ref_tok_axes = ref_specs.decode_token_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    assert tuple(tok.shape) == tuple(ref_tok.shape) and _same_dtype(tok, ref_tok)
    assert tuple(tok_axes.axes) == tuple(ref_tok_axes.axes)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_draw_nothing(arch):
    """The full-width params as meta tensors, element for element as many
    as the reference's ``eval_shape`` of its init (the port lists the
    layers where the reference may stack them), and the model's own spec
    tree, one ShardSpec a leaf of matching rank."""
    from repro.models.registry import build_model as ref_build_model

    model = build_model(ARCHS[arch])
    shapes, spec_tree = specs.param_shapes_and_specs(model)
    leaves = list(tree_leaves(shapes))
    assert all(t.device.type == "meta" for t in leaves)
    want, _ = ref_specs.param_shapes_and_specs(ref_build_model(REF_ARCHS[arch]))
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))
    flat_specs = []

    def walk(s):
        if isinstance(s, ShardSpec):
            flat_specs.append(s)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)
        else:
            for v in s:
                walk(v)

    walk(spec_tree)
    assert [len(s.axes) for s in flat_specs] == [t.ndim for t in leaves]
