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

On a mesh the LM families run SPMD on DTensors: `shard_tree` places the
params (each rank keeps its shard), ``constrain`` redistributes the
activations at the reference's hooks, and DTensor's own rules place
everything between them. Where DTensor has no rule that works, the
collective is written by hand: `vocab_parallel_rows` here (the embedding
lookup in a vocab-sharded table), the vocab-sharded cross-entropy in
`repro_torch.training.losses`, head-parallel attention in
`repro_torch.nn.attention`.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

from repro_torch._tree import tree_leaves, tree_map
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


def place(x, mesh: DeviceMesh, placements) -> DTensor:
    """``x`` as a DTensor with ``placements``: a DTensor is redistributed;
    a plain tensor, which must hold the same value on every rank, keeps
    its shard of itself (no communication, and autograd flows through).
    A tensor dim that its mesh dims do not split evenly stays whole
    (``Replicate()`` on them), as does any dim on a mesh dim of one rank:
    DTensor refuses to reshape a dim split unevenly, or "split" over one
    rank (the MoE's single token group, G = 1), where GSPMD pads."""
    placements = tuple(placements)
    ways = {}
    for m, p in enumerate(placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(m)
    placements = tuple(
        Replicate() if p.is_shard() and (mesh.size(m) == 1 or x.shape[p.dim] % ways[p.dim]) else p
        for m, p in enumerate(placements))
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, placements)


def make_constrain(mesh: DeviceMesh, rules: dict) -> Callable:
    """Returns constrain(x, logical_axes) for activation sharding hints:
    a DTensor is redistributed to the placements, a plain tensor (the
    same value on every rank) is placed on them (`place`).

    The returned callable also exposes ``constrain.tree(tree, spec_tree)``
    for a tree of tensors beside its ShardSpec tree.
    """
    mesh_axes = mesh.mesh_dim_names

    def constrain(x, logical_axes):
        return place(x, mesh, to_placements(to_pspec(tuple(logical_axes), rules, mesh_axes), mesh))

    def constrain_tree(tree, spec_tree):
        return tree_map(lambda x, s: constrain(x, s.axes), tree, spec_tree)

    constrain.tree = constrain_tree
    return constrain


def place_owned(x, mesh: DeviceMesh, placements) -> DTensor:
    """`place`, the shard copied out of ``x``'s storage: a rank then holds
    its shard's bytes alone (params, optimizer state), not a view that
    keeps the whole tensor alive."""
    d = place(x, mesh, placements)
    return DTensor.from_local(d.to_local().clone(), mesh, d.placements, shape=d.shape,
                              stride=d.stride(), run_check=False)


def shard_tree(tree, spec_tree, rules, mesh: DeviceMesh):
    """The tensors of ``tree`` (the same values on every rank) as DTensors
    placed by their ShardSpecs (`spec_tree_to_shardings`): each rank keeps
    only its shard (`place_owned`). Placing the reference's params is
    ``params_from_numpy``, then this."""
    return tree_map(lambda x, sh: place_owned(x, *sh), tree,
                    spec_tree_to_shardings(spec_tree, rules, mesh))


def full_tree(tree):
    """Every DTensor of ``tree`` as its full tensor (a collective: every
    rank of its mesh calls it), every other leaf as it is."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


@contextlib.contextmanager
def _implicit_replication():
    # torch's ``implicit_replication`` resets the flag to False on exit,
    # which would end an enclosing context (a train step's, around the
    # forward's own): this one restores what it found
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def spmd(tree):
    """The context a sharded computation over ``tree`` runs in: plain
    tensors that meet DTensors (positions, masks, zero states: the same
    value on every rank) count as replicated (DTensor's implicit
    replication). A no-op context for plain trees (a tree is placed as a
    whole: its first leaf tells)."""
    sharded = isinstance(next(tree_leaves(tree), None), DTensor)
    return _implicit_replication() if sharded else contextlib.nullcontext()


def vocab_parallel_rows(table: DTensor, ids) -> DTensor:
    """Rows ``ids`` of a DTensor ``table`` (V, D) whose rows may be split
    over mesh dims (``vocab → model``): a masked lookup in this rank's
    rows, zero where another rank holds the row, whose partial sums the
    next redistribute all-reduces (``Partial`` on those mesh dims). The
    ``D`` dim is gathered first (FSDP's ``embed → data``). DTensor's own
    embedding rule fails on such a table (an ``IndexError`` in
    ``MaskPartial`` with 2-D ids, torch 2.11-2.13), hence this by hand.
    ``ids``: a plain tensor, the same on every rank."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    local = table.redistribute(mesh, rows).to_local()
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, rows)
    lo, n = offset[0], local.shape[0]
    inside = (ids >= lo) & (ids < lo + n)
    picked = local[(ids - lo).clamp(0, max(n - 1, 0))]
    picked = torch.where(inside[..., None], picked, torch.zeros((), dtype=picked.dtype,
                                                                 device=picked.device))
    return DTensor.from_local(picked, mesh, [Partial() if p == Shard(0) else Replicate()
                                             for p in table.placements], run_check=False)


def shard_offsets(x: DTensor, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of ``x`` along ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def split_over(x: DTensor, dim: int):
    """The mesh dims that split ``x`` along ``dim`` (of more than 1 rank)."""
    return [m for m, p in enumerate(x.placements)
            if p == Shard(dim) and x.device_mesh.size(m) > 1]


def named(mesh: DeviceMesh, *axes):
    return mesh, to_placements(P(*axes), mesh)


def batch_pspec(rules, mesh_axes) -> PartitionSpec:
    return to_pspec(("batch",), rules, mesh_axes)
