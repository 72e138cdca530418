"""Per-rank counts of FLOPs, bytes and collectives, taken from the ops a
step dispatches — the port's counterpart of ``repro.runtime.hlo``, which
parses the compiled HLO of an SPMD program. The port has no HLO: it runs
its ops eagerly, so `OpCounter` (a ``TorchDispatchMode``) sees each aten
op one rank runs, real or fake (``FakeTensorMode``: shapes only), and a
Python loop is its own trip count.

Accounting (the reference's, per op instead of per HLO instruction):
  flops              2 · numel(result) · K per matmul-like op (``mm``,
                     ``addmm``, ``bmm``, ``baddbmm``; a convolution's K is
                     its weight's fan-in), the reference's ``_dot_flops``
  bytes              each op's tensor inputs once plus its outputs once,
                     a tensor's distinct elements (a broadcast dim counts
                     once). Views and allocations move nothing. A gather
                     (``index_select``, ``index``, ``gather``,
                     ``embedding``) moves its result twice and its index;
                     a slot write into a buffer (``index_copy_``,
                     ``index_put_``, ``scatter_``) its source twice and its
                     index, not the buffer; a ``copy_`` its source and its
                     destination. XLA fuses elementwise chains and counts
                     each fusion's boundary; the port counts what each of
                     its ops moves, which is what it runs.
  collective bytes   the wire bytes of the ring model, by the group's
                     size g, of each functional collective (DTensor's):
      all-gather          result × (g-1)/g
      all-reduce          2 × result × (g-1)/g
      reduce-scatter      result × (g-1)
      all-to-all          input × (g-1)/g (``all_to_all_single``, and
                          DTensor's Shard → Shard, ``shard_dim_alltoall``)
      collective-permute  result

DTensor ops are let through (``NotImplemented``): the mode counts the
local ops and collectives each rank runs, never the global op. DTensor's
sharding propagation runs an op once more on fake tensors of the global
shape the first time it meets an (op, shapes, placements) (it caches),
in the ambient fake mode if there is one: while a counter is active that
call counts nothing (`_mute_propagation`), and ops on fakes of another
mode than the counter's ``fake_mode`` never count, so the counts do not
depend on the cache.

**Kernel regions.** A hand-written kernel runs outside the dispatcher, so
no mode sees it. A layer that a kernel may implement opens a `region`
with the layer's work (a formula of its shapes: the GEMM FLOPs, its
inputs read once and its outputs written once); while a counter is
active the region adds that work, counts one ``fusion`` and mutes the ops
inside, so the kernel and the plain PyTorch path count the same. Without
an active counter a region is a shared no-op context: nothing runs
differently.

Memory: the counter also follows the storages the ops allocate (live
bytes and their peak), the counterpart of the reference's
``memory_analysis``.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the reference's ring factors (runtime/hlo.py), by HLO collective name
TRAFFIC_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}
# functional collectives (DTensor's) → the HLO name the reference counts by;
# DTensor's Shard → Shard is ``_dtensor.shard_dim_alltoall``
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional",
                         "_dtensor")
HISTOGRAM = ("fusion", "dot", "convolution", "scatter", "gather", "transpose", "copy")

_DOT_OPS = {"mm", "addmm", "bmm", "baddbmm"}
_GATHER_OPS = {"index_select", "index", "gather", "embedding"}
_SLOT_WRITES = {"index_copy_", "index_put_", "scatter_", "scatter_add_", "index_add_"}
_SCATTER_OPS = _SLOT_WRITES | {"index_copy", "index_put", "scatter", "scatter_add", "index_add",
                               "slice_scatter", "select_scatter", "masked_scatter"}
_TRANSPOSE_OPS = {"transpose", "permute", "t"}
_COPY_OPS = {"copy_", "clone", "_to_copy", "contiguous"}
# no bytes: allocations, metadata, scalar reads, waits
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_local_scalar_dense", "detach", "alias", "_unsafe_view", "lift_fresh",
             "lift_fresh_copy", "wait_tensor", "set_", "resize_"}

_state = threading.local()
_NULL = contextlib.nullcontext()


def _active() -> list:
    stack = getattr(_state, "counters", None)
    if stack is None:
        stack = _state.counters = []
    return stack


def region(name: str, work: Callable[[], Dict]):
    """The context a kernel-implementable layer runs in. ``work()`` (called
    only while a counter is active) returns the layer's ``flops`` and
    ``bytes`` (and optionally ``dots``: FLOPs by GEMM); every active
    counter adds them and counts the ops inside as nothing. Regions nest:
    the outermost counts. A backward that autograd runs on a thread of its
    own (a CUDA device's) has the caller's dispatch modes but not this
    thread's list: there the counters are taken from the mode stack."""
    stack = getattr(_state, "counters", None)
    if not stack and torch._C._len_torch_dispatch_stack():
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        stack = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, OpCounter)]
    if not stack:
        return _NULL
    return _Region(name, work, list(stack))


def _mute_propagation():
    """Wrap DTensor's shape propagation (once a process) so that what it
    runs counts nothing while a counter is active on this thread."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None or getattr(orig, "_muted_by_opcount", False):
        return

    def propagate(self, *args, **kwargs):
        with _muted():
            return orig(self, *args, **kwargs)

    propagate._muted_by_opcount = True
    setattr(ShardingPropagator, name, propagate)


@contextlib.contextmanager
def _muted():
    counters = list(getattr(_state, "counters", None) or ())
    for c in counters:
        c._muted += 1
    try:
        yield
    finally:
        for c in counters:
            c._muted -= 1


class _Region:
    def __init__(self, name, work, counters):
        self.name, self.work, self.counters = name, work, counters

    def __enter__(self):
        w = None
        for c in self.counters:
            if c._muted == 0:
                w = w if w is not None else self.work()
                c._add_region(self.name, w)
            c._muted += 1

    def __exit__(self, *exc):
        for c in self.counters:
            c._muted -= 1
        return False


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a dim of stride 0 (a broadcast)
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _group_size(args, kwargs, name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2] if len(args) >= 3 else kwargs["group_size"])
    group = kwargs.get("group_name", args[-1])
    return (_resolve_process_group(group) if isinstance(group, str) else group).size()


def dot_flops(name: str, args, out) -> float:
    """2 · numel(result) · K of a matmul-like op (0 for any other op)."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    return 0.0


class OpCounter(TorchDispatchMode):
    """While active (``with OpCounter() as c:``), counts what this rank's
    ops do: `result()` has ``analyze()``'s keys of the reference
    (``flops``, ``bytes_accessed``, ``collectives``, ``dot_flops_by_shape``)
    plus ``op_histogram``. ``fake_mode``: count the ops on fake tensors of
    this mode (a dry run); without it, the ops on real tensors."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_count: Dict[str, float] = defaultdict(float)
        self.dots: Dict[str, float] = defaultdict(float)
        self.histogram = {k: 0 for k in HISTOGRAM}
        self.regions: Dict[str, int] = defaultdict(int)
        self.n_ops = 0
        self._muted = 0
        # storages the ops allocated: id -> bytes, while alive
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        _mute_propagation()
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active().remove(self)
        return super().__exit__(*exc)

    # -- the mode --------------------------------------------------------

    def _foreign(self, tensors) -> bool:
        """True if an op runs on fakes of another mode than ours (DTensor's
        sharding propagation at the global shape), or on fakes while we
        count real tensors."""
        from torch._subclasses.fake_tensor import FakeTensor

        for t in tensors:
            if isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode:
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        ins = _tensors((args, kwargs))
        if self._foreign(ins):
            return out
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out):
        name = func._opname if hasattr(func, "_opname") else func.__name__.split(".")[0]
        ns = getattr(func, "namespace", "aten")
        outs = _tensors(out)
        self.n_ops += 1
        if ns in COLLECTIVE_NAMESPACES:
            if name in COLLECTIVES:
                kind = COLLECTIVES[name]
                g = _group_size(args, kwargs, name)
                sized = ins[:1] if kind == "all-to-all" else outs  # an all-to-all: its input
                size = sum(t.numel() * t.element_size() for t in sized)
                self.coll_bytes[kind] += size * TRAFFIC_FACTOR[kind](g)
                self.coll_count[kind] += 1
                self.bytes += sum(distinct_bytes(t) for t in ins + outs)
            self._track(outs, ins)
            return
        if name in _DOT_OPS or name == "convolution":
            f = dot_flops(name, args, outs[0])
            self.flops += f
            self.dots["x".join(map(str, outs[0].shape))] += f
            self.histogram["dot" if name in _DOT_OPS else "convolution"] += 1
        elif name in _SCATTER_OPS:
            self.histogram["scatter"] += 1
        elif name in _GATHER_OPS:
            self.histogram["gather"] += 1
        elif name in _TRANSPOSE_OPS:
            self.histogram["transpose"] += 1
        elif name in _COPY_OPS:
            self.histogram["copy"] += 1
        self.bytes += self._bytes(func, name, args, ins, outs)
        self._track(outs, ins)

    def _bytes(self, func, name, args, ins, outs) -> float:
        if not outs or name in _NO_BYTES or getattr(func, "is_view", False):
            return 0.0  # metadata (``prim::device``, sizes), scalar reads, views
        if name in _GATHER_OPS:
            idx = sum(distinct_bytes(t) for t in ins[1:] if not t.is_floating_point())
            return 2.0 * sum(distinct_bytes(t) for t in outs) + idx
        if name in _SLOT_WRITES:
            buf = ins[0]
            rest = [t for t in ins[1:]]
            src = sum(distinct_bytes(t) for t in rest if t.dtype == buf.dtype)
            idx = sum(distinct_bytes(t) for t in rest if t.dtype != buf.dtype)
            return 2.0 * src + idx
        if name == "copy_":
            return float(distinct_bytes(args[0]) + distinct_bytes(args[1])
                         if isinstance(args[1], torch.Tensor) else distinct_bytes(args[0]))
        if name in ("fill_", "zero_"):
            return float(distinct_bytes(args[0]))
        return float(sum(distinct_bytes(t) for t in ins) + sum(distinct_bytes(t) for t in outs))

    def _track(self, outs, ins):
        """Follow each new storage an op's outputs hold until it dies."""
        known = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in known or key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._release, key)

    def _release(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _add_region(self, name, work):
        self.flops += work["flops"]
        self.bytes += work["bytes"]
        for k, f in work.get("dots", {name: work["flops"]}).items():
            self.dots[k] += f
        self.histogram["fusion"] += 1
        self.regions[name] += 1

    # -- the result ------------------------------------------------------

    def result(self) -> Dict:
        """``repro.runtime.hlo.analyze``'s record, from what was counted."""
        top = dict(sorted(self.dots.items(), key=lambda kv: -kv[1])[:12])
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "collectives": {
                "bytes_by_op": dict(self.coll_bytes),
                "count_by_op": dict(self.coll_count),
                "total_bytes": float(sum(self.coll_bytes.values())),
                "total_count": float(sum(self.coll_count.values())),
            },
            "dot_flops_by_shape": top,
            "op_histogram": dict(self.histogram),
            "regions": dict(self.regions),
            "n_ops": self.n_ops,
        }


def analyze(fn: Callable, *args, fake_mode=None, **kwargs) -> Dict:
    """``fn(*args, **kwargs)`` under an `OpCounter`: its `result()`, with
    ``memory_analysis`` (the bytes of the arguments' storages, of the
    storages the result holds beyond them, the peak of what the ops
    allocated, and their sum as ``peak_live_bytes_est``), the seconds the
    call took (``trace_seconds``) and its return value (``out``)."""
    held = _storages((args, kwargs))
    t0 = time.perf_counter()
    with OpCounter(fake_mode=fake_mode) as c:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    res = c.result()
    arg_b = sum(held.values())
    returned = _storages(out)
    res["memory_analysis"] = {
        "argument_bytes": arg_b,
        "output_bytes": sum(n for k, n in returned.items() if k not in held),
        "temp_bytes": c.peak_bytes,
        "alias_bytes": sum(n for k, n in returned.items() if k in held),
        "peak_live_bytes_est": arg_b + c.peak_bytes,
    }
    res["trace_seconds"] = seconds
    res["out"] = out
    return res


def _storages(tree) -> Dict[int, int]:
    """{id: bytes} of the storages the tensors of ``tree`` hold (a
    DTensor's: its local shard's)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        s = t.untyped_storage()
        out[id(s)] = s.nbytes()
    return out


# ---------------------------------------------------------------------------
# the work of each kernel-implementable layer (the bound formulas of the
# kernel table in PERF.md §6)
# ---------------------------------------------------------------------------

def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def trunk_work(x, convs, seq_padded: int) -> Dict:
    """The c1/c3 k2s2 conv stack on ``x`` (B, N, C), padded to
    ``seq_padded`` rows: per layer a (B·N/2, 2C) × (2C, Co) GEMM. Reads
    ``x`` and every weight and bias once, writes the (B, N/2^depth, Co)
    output in f32 (as the kernels write it)."""
    B, _, C = x.shape
    flops, dots = 0.0, {}
    n, c = seq_padded, C
    for lp in convs:
        co = lp["w"].shape[1]
        n //= 2
        f = 2.0 * B * n * co * 2 * c
        flops += f
        dots[f"{B * n}x{co}"] = dots.get(f"{B * n}x{co}", 0.0) + f
        c = co
    moved = _nbytes(x, *(t for lp in convs for t in (lp["w"], lp["b"])))
    return {"flops": flops, "bytes": float(moved + B * n * c * 4), "dots": dots}


def fused_step_work(params, state, cur_feat, cur_addr, seq_padded: int) -> Dict:
    """One c3 predictor step off the ring state: K1's layer (the model
    input assembled from the planes, the conv trunk) and the FC head. The
    trunk's and the head's GEMMs; reads the planes the assembly uses
    (feat, addr, resid, exec/store latencies, valid), the current row and
    every weight once, writes the (L, 3) latencies."""
    L, Q, F = state.feat.shape
    x = torch.empty((L, 1 + Q, F + 9), dtype=torch.float32, device="meta")  # the 50 inputs
    w = trunk_work(x, [params[f"conv{i}"] for i in range(3)], seq_padded)
    flops, dots = w["flops"], dict(w["dots"])
    for fc in (params["fc0"], params["fc1"]):
        k, n = fc["w"].shape
        flops += 2.0 * L * k * n
        dots[f"{L}x{n}"] = dots.get(f"{L}x{n}", 0.0) + 2.0 * L * k * n
    trunk_out = L * (seq_padded // 8) * params["conv2"]["w"].shape[1] * 4
    planes = _nbytes(state.feat, state.addr, state.resid, state.exec_lat, state.store_lat,
                     state.valid, cur_feat, cur_addr)
    moved = (w["bytes"] - _nbytes(x) - trunk_out + planes
             + _nbytes(*(t for i in range(2) for t in params[f"fc{i}"].values())) + L * 3 * 4)
    return {"flops": flops, "bytes": float(moved), "dots": dots}


def live_positions(cache_len, S: int, window: int = 0, offset: int = 0,
                   full: Optional[int] = None) -> int:
    """The cache positions of ``[offset, offset + S)`` that one decode step
    attends: below ``cache_len`` and, with a window, within its last
    ``window``. ``cache_len`` is read on the host (real tensors: a sync,
    only while counting); a fake one (a dry run) stands for a full cache
    of ``full`` positions (the whole cache's length; ``offset + S`` by
    default), under the same window."""
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(cache_len, FakeTensor):
        n = offset + S if full is None else full
    else:
        n = int(cache_len)
    lo = max(n - window, 0) if window > 0 else 0
    return max(min(n, offset + S) - max(lo, offset), 0)


def decode_attn_work(q, k, v, cache_len, *, window: int = 0, offset: Optional[int] = None,
                     full: Optional[int] = None) -> Dict:
    """K4's layer: one token's GQA attention over the live positions
    (`live_positions`; ``full``: the whole cache's length where ``k`` and
    ``v`` are a shard of it): 4 · B · H · S_live · hd FLOPs (QK and PV);
    reads q and the live K/V once, writes the context (and, in shard
    mode, f32 context and the log-sum-exp)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    live = live_positions(cache_len, S, window, offset or 0, full)
    flops = 4.0 * B * H * live * hd
    kv = 2 * B * live * KV * hd * k.element_size()
    out = B * H * hd * (4 if offset is not None else q.element_size())
    lse = B * H * 4 if offset is not None else 0
    return {"flops": flops, "bytes": float(_nbytes(q) + kv + out + lse),
            "dots": {"decode_attn": flops}}


def wkv_work(r, k, v, w, u, s0, *, states: int = 0, backward: bool = False) -> Dict:
    """rwkv6's wkv recurrence over (B, T, H, hd) r, k, v, w from the state
    s0 (`kernels.ops.wkv`), or its backward. FLOPs: those the plain loop
    (`kernels.ref.wkv_ref`) counts, its one einsum a step as a GEMM (2 · B
    · H · hd² a step), two a step in its backward. Bytes: what the kernels
    move, each tensor once: the forward reads r, k, v, w, u and s0 and
    writes y and the last state, the backward reads those inputs and gy,
    g(S_T) and writes a gradient of each input; both move ``states`` bytes
    of saved states (written by the forward, read by the backward)."""
    B, T, H, hd = r.shape
    flops = 2.0 * B * T * H * hd * hd * (2 if backward else 1)
    ins = _nbytes(r, k, v, w, u, s0)
    moved = 2 * ins + _nbytes(r, s0) if backward else ins + _nbytes(r, s0)
    return {"flops": flops, "bytes": float(moved + states), "dots": {"wkv": flops}}
