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
import math
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
    placements = even_placements(x.shape, mesh, tuple(placements))
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
    mesh = table.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    local = table.redistribute(mesh, rows).to_local()
    _, offset = local_shape_and_offset(table.shape, mesh, rows)
    lo, n = offset[0], local.shape[0]
    inside = (ids >= lo) & (ids < lo + n)
    picked = local[(ids - lo).clamp(0, max(n - 1, 0))]
    picked = torch.where(inside[..., None], picked, torch.zeros((), dtype=picked.dtype,
                                                                 device=picked.device))
    return DTensor.from_local(picked, mesh, [Partial() if p == Shard(0) else Replicate()
                                             for p in table.placements], run_check=False)


def shard_offsets(x: DTensor, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of ``x`` along ``dim``."""
    shape, offset = local_shape_and_offset(x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def local_shape_and_offset(shape, mesh: DeviceMesh, placements) -> Tuple[tuple, tuple]:
    """(shape, first index along each dim) of this rank's shard of a
    tensor of ``shape`` placed by ``placements`` (``Shard``/``Replicate``/
    ``Partial``): DTensor's layout, each ``Shard(d)`` cutting dim ``d``
    into ceil-sized pieces in mesh-dim order (the last may be short or
    empty). Host integers only: torch's own helper builds index tensors,
    which a fake tensor mode cannot read back."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if p.is_shard():
            d, n = p.dim, mesh.size(m)
            piece = -(-shape[d] // n)
            start = min(coord[m] * piece, shape[d])
            offset[d] += start
            shape[d] = min(piece, shape[d] - start)
    return tuple(shape), tuple(offset)


def cuts_groups(x, dim: int, n: int) -> bool:
    """True if ``x`` is a DTensor whose ``dim`` is split over ranks that do
    not divide ``n``: a reshape of that dim into ``n`` groups (heads, say)
    would cut a group, which DTensor refuses (GSPMD pads)."""
    if not isinstance(x, DTensor):
        return False
    dim %= x.ndim
    return n % math.prod(x.device_mesh.size(m) for m, p in enumerate(x.placements)
                         if p.is_shard(dim)) != 0


def whole_if_uneven(x, dim: int, n: int):
    """``x`` with ``dim`` gathered over the mesh dims that split it where
    they cut ``n`` groups (`cuts_groups`); otherwise ``x`` as it is."""
    if not cuts_groups(x, dim, n):
        return x
    dim %= x.ndim
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in x.placements])


def split_over(x: DTensor, dim: int):
    """The mesh dims that split ``x`` along ``dim`` (of more than 1 rank)."""
    return [m for m, p in enumerate(x.placements)
            if p == Shard(dim) and x.device_mesh.size(m) > 1]


def local(x):
    """This rank's tensor: a DTensor's local shard, any other tensor as it
    is."""
    return x.to_local() if isinstance(x, DTensor) else x


def even_placements(shape, mesh: DeviceMesh, placements) -> Tuple[Placement, ...]:
    """``placements`` with `place`'s rule applied: a dim that its mesh dims
    do not split evenly, or a mesh dim of one rank, stays whole."""
    ways = {}
    for m, p in enumerate(placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(m)
    return tuple(Replicate() if p.is_shard() and (mesh.size(m) == 1 or shape[p.dim] % ways[p.dim])
                 else p for m, p in enumerate(placements))


def grow_along(src: DTensor, shape) -> DTensor:
    """A DTensor of ``shape`` placed as ``src`` is (zeros; `place`'s rule
    for dims that no longer split evenly), holding ``src``'s values in its
    leading positions along the one dim where the shapes differ: a prompt's
    KV cache re-homed into a longer decode state. Each rank writes its own
    positions of the grown dim: ``src`` is gathered over the mesh dims
    that split that dim one index of its leading dim (a layer) at a time,
    so no rank ever holds the whole of ``src``."""
    from torch.distributed.tensor import zeros

    grown = [d for d, (a, b) in enumerate(zip(src.shape, shape)) if a != b]
    if len(grown) != 1 or src.ndim != len(shape):
        raise ValueError(f"cannot grow {tuple(src.shape)} into {tuple(shape)} along one dim")
    d = grown[0]
    mesh = src.device_mesh
    placements = even_placements(shape, mesh, src.placements)
    dst = zeros(tuple(shape), dtype=src.dtype, device_mesh=mesh, placements=placements)
    off, n = shard_offsets(dst, d)
    lo, hi = off, min(off + n, src.shape[d])
    whole = [Replicate() if p.is_shard(d) else p for p in placements]
    steps = range(src.shape[0]) if d != 0 and not any(p.is_shard(0) for p in placements) else [None]
    out = dst.to_local()
    for i in steps:
        part = src if i is None else src[i:i + 1]
        got = part.redistribute(mesh, whole).to_local()
        if hi > lo:
            row = out if i is None else out[i:i + 1]
            row.narrow(d, 0, hi - lo).copy_(got.narrow(d, lo, hi - lo))
    return dst


def argmax_last(logits) -> torch.Tensor:
    """``torch.argmax(logits, -1)`` as int32, ties to the first maximum (as
    ``jnp.argmax``); the same plain tensor on every rank. Logits whose last
    (vocab) dim is split over mesh dims are not gathered: each rank takes
    its shard's maximum and its global index, the ranks gather those
    (every mesh dim that splits a dim of the logits), and the first of the
    largest wins, which is the lowest index since shards follow the vocab
    in order."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mesh, last = logits.device_mesh, logits.ndim - 1
    shard = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                       for p in logits.placements])
    off, _ = shard_offsets(shard, last)
    part = shard.to_local()
    at = torch.argmax(part, dim=-1, keepdim=True)  # the shard's first maximum
    best = part.gather(-1, at)
    # (..., 1, 2): the shard's dim `last` becomes one entry of the gathered one
    cand = torch.cat([best.double(), (at + off).double()], dim=-1)[..., None, :]
    cand = DTensor.from_local(cand, mesh, shard.placements, run_check=False).full_tensor()
    top = cand[..., 0].max(dim=-1, keepdim=True).values
    first = torch.argmax((cand[..., 0] == top).to(torch.int8), dim=-1, keepdim=True)
    return cand[..., 1].gather(-1, first)[..., 0].to(torch.int32)


def named(mesh: DeviceMesh, *axes):
    return mesh, to_placements(P(*axes), mesh)


def batch_pspec(rules, mesh_axes) -> PartitionSpec:
    return to_pspec(("batch",), rules, mesh_axes)
