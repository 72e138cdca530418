"""Device meshes — the port of ``repro.launch.mesh`` onto
``torch.distributed.device_mesh.init_device_mesh`` (functions, not module
constants: importing this module touches no process group).

A mesh spans the ranks of the default process group. When there is none,
a function that needs one starts a one-process group itself (gloo on
``"cpu"``; on ``"cuda"`` gloo for CPU tensors and NCCL for CUDA tensors),
so a one-process caller gets a mesh without ``torchrun``. Under
``torchrun`` or any other launcher, initialise the group first
(``torch.distributed.init_process_group``, or `init_ranks`, which picks
the backend); every rank then calls the same function and gets the same
mesh over the whole world.

Backends (`rank_backend`): gloo on the CPU; on CUDA, NCCL for CUDA
tensors when every rank on a host has a card of its own, and gloo when
ranks share a card (NCCL refuses two ranks on one device). Gloo's
functional all-gather on CUDA tensors, which DTensor's ``Shard →
Replicate`` runs, crashes the process (SIGSEGV, torch 2.11 on the H100),
its reduce-scatter goes through host memory, and it has no all-to-all
on CUDA tensors (DTensor's ``Shard → Shard``); ranks that share a card
run these collectives through each other's device buffers instead
(`exchange_through_peer_buffers`, CUDA IPC), so the ranks' data never
leaves the card.
"""
from __future__ import annotations

import collections
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import resolve_device

# the backends of a group a mesh function starts itself, by device type
WORLD1_BACKENDS = {"cpu": "gloo", "cuda": "cpu:gloo,cuda:nccl"}
SHARED_CARD_BACKEND = "cpu:gloo,cuda:gloo"

# what `exchange_through_peer_buffers` moved: bytes (each rank's input) by
# collective
EXCHANGED = collections.Counter()
EXCHANGE_MIN_BYTES = 64 << 20  # buffers grow in steps of this
_exchange_libs, _exchanges = {}, {}


def rank_backend(device_type: str, world_size: int, n_cards: int = 0,
                 local_world_size: int | None = None) -> str:
    """The process group's backend for ``world_size`` ranks on
    ``device_type``, ``local_world_size`` of them (default: all) on this
    host: ``"gloo"`` on the CPU; on CUDA NCCL when each rank of the host
    has a card of its own (``n_cards >= local_world_size``), else gloo for
    CUDA tensors too (ranks share a card)."""
    if device_type == "cpu":
        return "gloo"
    local = world_size if local_world_size is None else local_world_size
    return WORLD1_BACKENDS["cuda"] if n_cards >= local else SHARED_CARD_BACKEND


class _PeerBuffers:
    """One process group's exchange: each rank holds two byte buffers
    (slots) that every other rank of the group maps. A collective writes
    this rank's input into the next slot, waits for the group (its stream
    synchronised, then a barrier) and reads the peers' slots. Collective k
    uses slot k % 2, so the one barrier a collective also orders a peer's
    reads of a slot before this rank's next write to it. Every rank of the
    group makes the same collectives with the same sizes, so all grow
    their buffers at the same call."""

    def __init__(self, group, device: torch.device, root):
        self.group, self.device, self.root = group, device, root
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.calls, self.capacity, self.mine, self.peers = 0, 0, [], []

    def _wait_for_group(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def _alloc(self, n_bytes, slot):
        """A buffer of this rank and what another rank opens it by."""
        if self.device.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor

            buf = torch.empty(n_bytes, dtype=torch.uint8, device=self.device)
            return buf, reduce_tensor(buf)
        path = f"{self.root}/{self.group.group_name}.{self.rank}.{slot}.{n_bytes}"
        return torch.from_file(path, shared=True, size=n_bytes, dtype=torch.uint8), path

    def _open(self, handle, n_bytes):
        if self.device.type == "cuda":
            rebuild, args = handle
            return rebuild(*args)
        return torch.from_file(handle, shared=True, size=n_bytes, dtype=torch.uint8)

    def _grow(self, n_bytes):
        if self.mine:  # every peer's reads of the old buffers are done
            self._wait_for_group()
        self.mine = self.peers = []
        cap = -(-n_bytes // EXCHANGE_MIN_BYTES) * EXCHANGE_MIN_BYTES
        mine = [self._alloc(cap, slot) for slot in range(2)]
        handles = [None] * self.size
        dist.all_gather_object(handles, [h for _, h in mine], group=self.group)
        self.mine = [b for b, _ in mine]
        self.peers = [self.mine if r == self.rank else [self._open(h, cap) for h in hs]
                      for r, hs in enumerate(handles)]
        dist.barrier(group=self.group)  # every rank holds its peers' buffers
        if self.device.type != "cuda":
            for _, path in mine:
                os.unlink(path)
        self.capacity = cap

    def publish(self, x: torch.Tensor, numels=None):
        """Every rank's ``x`` in group rank order, as views of the ranks'
        slots: of ``x``'s shape (the same shape and dtype on each rank),
        or, given ``numels`` (every rank's element count, the same list on
        each rank), flat of ``numels[r]`` elements for rank r."""
        n = x.numel() * x.element_size()
        most = n if numels is None else max(numels) * x.element_size()
        if not self.mine or most > self.capacity:
            self._grow(max(most, 1))
        slot = self.calls % 2
        self.calls += 1
        self.mine[slot][:n].copy_(x.contiguous().reshape(-1).view(torch.uint8))
        self._wait_for_group()
        if numels is None:
            return [p[slot][:n].view(x.dtype).view(x.shape) for p in self.peers]
        return [p[slot][:k * x.element_size()].view(x.dtype) for p, k in zip(self.peers, numels)]


def _peer_buffers(group, device: torch.device) -> _PeerBuffers:
    """The exchange of ``group`` (a process group or its name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):
        group = _resolve_process_group(group)
    ex = _exchanges.get(group.group_name)
    if ex is None or ex.group is not group:  # a name of an earlier world is reused
        ex = _exchanges[group.group_name] = _PeerBuffers(group, device,
                                                         _exchange_libs[device.type][1])
    return ex


def close_peer_buffers():
    """Drops this process's peer buffers (its own and its mappings of the
    other ranks'); call it on every rank before the group ends. A later
    collective makes new ones."""
    if torch.cuda.is_available() and any(ex.device.type == "cuda" for ex in _exchanges.values()):
        torch.cuda.synchronize()
    _exchanges.clear()


def _exchanged_all_gather(tensor, group_size, group_name):
    parts = _peer_buffers(group_name, tensor.device).publish(tensor)
    EXCHANGED["all_gather_into_tensor"] += tensor.numel() * tensor.element_size()
    return torch.cat(parts)


def _exchanged_reduce_scatter(tensor, reduce_op, group_size, group_name):
    if reduce_op not in ("sum", "avg"):
        raise NotImplementedError(f"reduce_scatter_tensor with {reduce_op!r} through peer buffers")
    ex = _peer_buffers(group_name, tensor.device)
    n = tensor.shape[0] // group_size
    out = None
    for part in ex.publish(tensor):  # summed in group rank order on every rank
        mine = part[ex.rank * n:(ex.rank + 1) * n]
        out = mine.clone() if out is None else out.add_(mine)
    EXCHANGED["reduce_scatter_tensor"] += tensor.numel() * tensor.element_size()
    return out.div_(group_size) if reduce_op == "avg" else out


def _exchanged_all_to_all(tensor, output_split_sizes, input_split_sizes, group_name):
    """``all_to_all_single``: rank r's rows ``input_split_sizes[j]`` go to
    rank j, in rank order (equal splits where the sizes are empty). Every
    rank's split sizes are exchanged first, so each knows where its rows
    lie in a peer's input."""
    ex = _peer_buffers(group_name, tensor.device)
    g, row = ex.size, math.prod(tensor.shape[1:])
    mine = list(input_split_sizes) or [tensor.shape[0] // g] * g
    splits = [p.tolist() for p in ex.publish(torch.tensor(mine, device=tensor.device))]
    parts = ex.publish(tensor, [sum(s) * row for s in splits])
    out = [part[sum(s[:ex.rank]) * row:sum(s[:ex.rank + 1]) * row]
           for part, s in zip(parts, splits)]
    EXCHANGED["all_to_all_single"] += tensor.numel() * tensor.element_size()
    return torch.cat(out).view(-1, *tensor.shape[1:])


def _exchanged_shard_dim_alltoall(tensor, gather_dim, shard_dim, group_name):
    """DTensor's ``Shard(gather_dim) → Shard(shard_dim)``: every rank's
    ``tensor`` (one shape on each) cut into group-size chunks along
    ``shard_dim``; this rank takes its chunk of each, joined along
    ``gather_dim`` in group rank order."""
    ex = _peer_buffers(group_name, tensor.device)
    n = tensor.shape[shard_dim] // ex.size
    parts = [p.narrow(shard_dim, ex.rank * n, n) for p in ex.publish(tensor)]
    EXCHANGED["shard_dim_alltoall"] += tensor.numel() * tensor.element_size()
    return torch.cat(parts, gather_dim)


def exchange_through_peer_buffers(device_type: str = "cuda", root=None) -> str:
    """From now on in this process, the functional all-gather,
    reduce-scatter and all-to-all (``_c10d_functional``'s
    ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_to_all_single``: DTensor's ``Shard → Replicate`` and ``Partial →
    Shard``) and DTensor's ``Shard → Shard`` (``_dtensor.shard_dim_alltoall``)
    of ``device_type`` tensors run through buffers
    that every rank of the group maps (`_PeerBuffers`): on CUDA, device
    memory shared by CUDA IPC, for ranks on one host; on the CPU (tests),
    files under ``root`` mapped by every rank and unlinked once mapped.
    Every other collective is the backend's own. Returns what is routed
    (also printed); `EXCHANGED` counts the bytes. Idempotent."""
    if device_type not in _exchange_libs:
        if device_type != "cuda" and root is None:
            raise ValueError("on the CPU the peer buffers are files: give their directory, root")
        key = device_type.upper()
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _exchanged_all_gather, key)
        lib.impl("reduce_scatter_tensor", _exchanged_reduce_scatter, key)
        lib.impl("all_to_all_single", _exchanged_all_to_all, key)
        # DTensor's Shard → Shard calls this op, which reaches the process
        # group's all-to-all directly, not through all_to_all_single
        dtensor_lib = torch.library.Library("_dtensor", "IMPL")
        dtensor_lib.impl("shard_dim_alltoall", _exchanged_shard_dim_alltoall, key)
        _exchange_libs[device_type] = ((lib, dtensor_lib), root)
    how = "CUDA IPC" if device_type == "cuda" else "mapped files"
    what = (f"_c10d_functional.all_gather_into_tensor, reduce_scatter_tensor and "
            f"all_to_all_single and _dtensor.shard_dim_alltoall on {device_type} tensors, "
            f"through the ranks' buffers ({how})")
    print(f"[mesh] exchanged: {what}", flush=True)
    return what


class CollectiveCounter(TorchDispatchMode):
    """While active, counts the collectives this rank dispatches: calls
    and bytes by kind (the op's name: ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ...), the bytes being those
    of the tensors the rank hands in (an all-gather's shard, a
    reduce-scatter's whole input). Functional collectives (DTensor's, in
    ``_c10d_functional``) and ``torch.distributed`` calls (``c10d``) both
    count, and DTensor's ``Shard → Shard`` (``_dtensor``'s
    ``shard_dim_alltoall``, which reaches the process group without a
    functional collective); ``wait_tensor`` and the autograd wrapper do
    not. A DTensor op
    is let through first (``NotImplemented``), so the collectives its
    redistributes run are seen on their plain tensors, as
    ``CommDebugMode`` sees them."""

    NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")
    NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.bytes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        name = getattr(func, "_opname", "")
        if getattr(func, "namespace", None) in self.NAMESPACES and name not in self.NOT_COLLECTIVES:
            first = args[0] if args else None
            ts = first if isinstance(first, (list, tuple)) else [first]
            self.calls[name] += 1
            self.bytes[name] += sum(t.numel() * t.element_size() for t in ts
                                    if isinstance(t, torch.Tensor))
        return func(*args, **kwargs)


def init_ranks(rank: int, world_size: int, init_method: str, device_type: str = "cuda",
               timeout_s: float = 600.0) -> str:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method``, with `rank_backend`'s backend (printed on rank 0).
    torchrun's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` place the rank among
    those of its host (without them, the whole world is on one host). On
    CUDA a rank takes card ``LOCAL_RANK % cards``; ranks that share a card
    exchange their all-gathers and reduce-scatters through each other's
    buffers (`exchange_through_peer_buffers`), which needs the whole world
    on one host. Returns the backend."""
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = rank_backend(device_type, world_size, n_cards, local_world_size)
    if backend == SHARED_CARD_BACKEND and local_world_size != world_size:
        raise NotImplementedError(
            f"{local_world_size} ranks share {n_cards} cards on each of several hosts: ranks "
            f"exchange through peer buffers only when the whole world is on one host")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[mesh] {world_size} ranks on {device_type} ({local_world_size} on a host with "
              f"{n_cards} cards): backend {backend}", flush=True)
    if backend == SHARED_CARD_BACKEND:
        exchange_through_peer_buffers(device_type)
    return backend


def ensure_process_group(device_type: str = "cuda") -> int:
    """The default process group's world size, after starting a
    one-process group (an in-memory store, rank 0) when none exists."""
    resolve_device(device_type)  # "cuda" without a GPU raises
    if not dist.is_initialized():
        dist.init_process_group(WORLD1_BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh (elastic scaling uses this with recomputed shapes)."""
    ensure_process_group(device_type)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world (tests,
    examples): (world // model_axis, model_axis)."""
    n = ensure_process_group(device_type)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the world of {n} ranks")
    data = n // model_axis
    return make_mesh((data, model_axis), ("data", "model"), device_type)
