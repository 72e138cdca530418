"""Logical-axis → mesh-axis rule tables and sharding helpers — the port of
``repro.runtime.sharding`` onto ``DeviceMesh`` and DTensor placements.

Logical axes used by param ShardSpecs and activation constraints:
  embed    d_model dim of weight matrices (FSDP-sharded in train mode)
  embed2   secondary d_model (square matrices: rwkv wr)
  mlp      ffn hidden dim (tensor-parallel)
  heads    attention head product dim (tensor-parallel)
  vocab    vocabulary dim (tensor-parallel)
  expert   MoE expert dim (expert-parallel when cfg.moe_ep)
  layers   scan-stacked layer dim (never sharded)
  batch    activation batch dim (data-parallel, pods × data)
  seq      activation sequence dim (sequence-parallel over "model")
  kvseq    KV-cache sequence dim (sharded over "model"; over everything
           for long-context batch-1 decode)

A `PartitionSpec` is the port's own: one entry per tensor dim, each a
mesh-axis name, a tuple of names (the dim split over several mesh axes,
major to minor) or None. `to_placements` turns one into the DTensor
placements of a mesh, one ``Shard``/``Replicate`` per mesh dim. A
sharding is the pair ``(mesh, placements)``, the counterpart of the
reference's ``NamedSharding``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from repro_torch._tree import tree_map
from repro_torch.nn.init import ShardSpec


class PartitionSpec(tuple):
    """``PartitionSpec("data", None, ("pod", "model"))``: a tuple of the
    entries, equal to the reference's ``PartitionSpec`` of the same ones."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def rules_for(cfg, mode: str) -> dict:
    """mode: train | prefill | decode | decode_long."""
    moe_ep = bool(getattr(cfg, "moe_ep", False))
    train = mode == "train"
    rules = {
        "embed": "data" if train else None,
        "embed2": "model",
        "mlp": None if moe_ep else "model",
        "heads": "model",
        "vocab": "model",
        "expert": "model" if moe_ep else None,
        "layers": None,
        "batch": ("pod", "data"),
        "seq": "model" if getattr(cfg, "seq_shard_activations", True) else None,
        "kvseq": "model",
    }
    if mode == "decode_long":
        rules["batch"] = None
        rules["kvseq"] = ("pod", "data", "model")
    return rules


def _filter_axes(entry, mesh_axes):
    """Drop physical axes not present in the mesh (e.g. 'pod' single-pod)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh_axes else None
    kept = tuple(a for a in entry if a in mesh_axes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def to_pspec(axes: Sequence, rules: dict, mesh_axes: Sequence[str]) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec."""
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        else:
            out.append(_filter_axes(rules.get(a), mesh_axes))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def to_placements(pspec: Sequence, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The DTensor placements of ``pspec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on the
    others. A dim split over several mesh axes takes them major to minor,
    which DTensor does in mesh-dim order: the entry must name them in the
    mesh's order."""
    names = tuple(mesh.mesh_dim_names or ())
    placements = [Replicate()] * mesh.ndim
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"mesh axes {missing} of {tuple(pspec)} are not in the mesh {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{axes} is not in the mesh's major-to-minor order {names}")
        for m in dims:
            if not isinstance(placements[m], Replicate):
                raise ValueError(f"mesh axis {names[m]!r} shards two dims of {tuple(pspec)}")
            placements[m] = Shard(d)
    return tuple(placements)


def spec_tree_to_shardings(spec_tree, rules, mesh: DeviceMesh):
    """Map a tree of ShardSpec leaves to ``(mesh, placements)`` leaves."""
    mesh_axes = mesh.mesh_dim_names

    def convert(s):
        if isinstance(s, ShardSpec):
            return mesh, to_placements(to_pspec(s.axes, rules, mesh_axes), mesh)
        raise TypeError(f"expected ShardSpec, got {type(s)}")

    return tree_map(convert, spec_tree)


def make_constrain(mesh: DeviceMesh, rules: dict) -> Callable:
    """Returns constrain(x, logical_axes) for activation sharding hints:
    a DTensor is redistributed to the placements, a plain tensor (the
    same value on every rank) is distributed to them.

    The returned callable also exposes ``constrain.tree(tree, spec_tree)``
    for a tree of tensors beside its ShardSpec tree.
    """
    mesh_axes = mesh.mesh_dim_names

    def place(x, logical_axes):
        placements = to_placements(to_pspec(tuple(logical_axes), rules, mesh_axes), mesh)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements)
        return distribute_tensor(x, mesh, placements)

    def constrain(x, logical_axes):
        return place(x, logical_axes)

    def constrain_tree(tree, spec_tree):
        return tree_map(lambda x, s: place(x, s.axes), tree, spec_tree)

    constrain.tree = constrain_tree
    return constrain


def named(mesh: DeviceMesh, *axes):
    return mesh, to_placements(P(*axes), mesh)


def batch_pspec(rules, mesh_axes) -> PartitionSpec:
    return to_pspec(("batch",), rules, mesh_axes)
