"""SimNet parallel-simulation engine (paper §3.3) — the port of
``repro.serving.simnet_engine``.

``simulate_many`` packs lanes from many workloads × SimConfigs into one
lane batch (per-lane workload ids, validity masks for ragged trace
lengths, per-lane retire width / context capacity) and streams the time
axis through chunks, with the lane count rounded up to a power of two
(dead lanes are masked and add exactly nothing). ``simulate`` is the
single-workload case of the same path. The step's predictor is chosen by
the same kernel gate as the reference's:

  ring layout + c3 + f32 state + ``use_kernel`` → the fused sim-step kernel
    (`kernels.ops.fused_step`: input assembly + trunk off the ring state);
  otherwise ``use_kernel`` → the trunk kernel (`kernels.ops.cnn_trunk`)
    on the assembled input (roll layout, bf16 state); else plain torch.

The chunk program is **resident**: programs come from the device's
`serving.compile_cache` keyed by architecture (never weights), as the
reference's executables do. On the card a program is a `ChunkGraph`, one
CUDA graph of a whole chunk (``chunk`` steps of `run_chunk`) over static
buffers: the `SimState` planes, the chunk's ``xs``, the per-lane retire
width and context, and parameter slots. The capture ends by copying the
chunk's final state into the static state, so consecutive replays chain.
A pass zeroes the state, refills the slots if the entry last ran other
weights (other tensors, or the same ones updated in place: a
`ParamsBinding`), then per chunk copies ``xs`` in and replays; the totals are read
from the static state after the last chunk. Two engines of the same kind
share one graph. On the CPU a program is the eager chunk function
(`ChunkProgram`) under the same cache and counters.

**The lane mesh.** ``SimNetEngine(mesh=)`` splits the lanes of the
power-of-two bucket over the mesh's lane axes, pod then data (the
reference's ``P(("pod", "data"))``); ``head``, the weights and the
program are the same on every rank, and ranks that differ only on the
``model`` axis run the same lanes. One process drives the mesh: the
controller (the rank at coordinate 0 on every axis) runs everything above
the engine, and every other rank serves it in `follow`. A call sends each
follower one request (the program key, the weights, its lane slice of the
pack), every rank streams its slice through its own chunk program at its
local lane count (K1 on the fused route), and the controller gathers the
per-lane totals back in lane order and reduces them as one rank would.
Nothing is exchanged inside a chunk: the lanes never communicate. The
exchange is point to point on the default process group with CPU tensors
(gloo), which also serves several ranks on one card, where NCCL refuses.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
import time
from datetime import timedelta
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.core import features as F
from repro_torch.core.predictor import (
    PredictorConfig,
    apply_raw,
    decode_latency,
    fused_step_region,
    make_fused_predict_fn,
)
from repro_torch.core.simulator import (
    PackedWorkloads,
    SimConfig,
    SimState,
    drain_cycles,
    init_state,
    lane_sums,
    make_sim_scan,
    model_input,
    pack_workloads,
    packed_tensors,
    pad_packed_lanes,
    run_steps,
    workload_totals,
)
from repro_torch.serving import faults
from repro_torch.serving.compile_cache import (
    CompileCache,
    ExecutableKey,
    device_key,
    global_cache,
    lane_bucket,
    mesh_fingerprint,
)
from repro_torch.serving.graphs import CapturedGraph, ParamsBinding


class NumericError(RuntimeError):
    """Predictor outputs produced non-finite cycle totals (NaN/Inf).

    Raised by the numeric guard in ``simulate_many`` so a poisoned batch
    fails loudly instead of silently corrupting CPI totals downstream."""

    def __init__(self, bad_workloads, cycles):
        self.bad_workloads = [int(i) for i in bad_workloads]
        super().__init__(
            f"non-finite cycle totals for workload(s) {self.bad_workloads}: "
            f"{[float(cycles[i]) for i in self.bad_workloads]}"
        )


def chunk_specs(n_lanes: int, chunk: int) -> Dict[str, tuple]:
    """(shape, dtype) of each tensor of one chunk of packed trace input."""
    return {
        "feat": ((chunk, n_lanes, F.STATIC_END), torch.float32),
        "addr": ((chunk, n_lanes, F.N_ADDR_KEYS), torch.int32),
        "is_store": ((chunk, n_lanes), torch.bool),
        "labels": ((chunk, n_lanes, 3), torch.float32),
        "active": ((chunk, n_lanes), torch.bool),
    }


def uses_fused_step(pcfg: Optional[PredictorConfig], sim_cfg: SimConfig,
                    use_kernel: bool) -> bool:
    """The kernel gate: ring layout + c3 + f32 state + ``use_kernel``."""
    return (pcfg is not None and use_kernel and sim_cfg.layout == "ring"
            and pcfg.kind == "c3" and sim_cfg.state_dtype == "float32")


# repro-lint: scan-reachable — the per-chunk body (a CUDA graph's body on the card)
def run_chunk(pcfg: Optional[PredictorConfig], sim_cfg: SimConfig, use_kernel: bool, params,
              state: SimState, xs, retire_width, lane_ctx) -> SimState:
    """Step ``state`` through the (T, L, ...) chunk ``xs`` with the
    predictor ``params`` (None: teacher-forced)."""
    predict = predict_state = None
    if pcfg is not None:
        def predict(x):
            raw = apply_raw(params, x, pcfg, use_kernel=use_kernel)
            return decode_latency(raw, pcfg)

        if uses_fused_step(pcfg, sim_cfg, use_kernel):
            # fused sim-step: assembly + conv trunk in one kernel off the
            # ring buffer. f32 state only: the kernel assembles in f32,
            # while the unfused path rounds the dynamic features through
            # the state dtype — a bf16 state goes to the path below.
            predict_state = make_fused_predict_fn(params, pcfg)
        elif uses_fused_step(pcfg, sim_cfg, True):
            # the fused step's configuration without the kernel: the
            # step's own model_input + predict, counted as K1's step
            def predict_state(state, cur_feat, cur_addr):
                with fused_step_region(params, pcfg, state, cur_feat, cur_addr):
                    return predict(model_input(state, cur_feat, cur_addr, sim_cfg))
    step = make_sim_scan(
        predict, sim_cfg,
        retire_width=retire_width, lane_ctx=lane_ctx, emit_outputs=False,
        predict_state_fn=predict_state,
    )
    state, _ = run_steps(step, state, xs)
    return state


class ChunkProgram:
    """The chunk program of one key on the CPU: `run_chunk`, eagerly, on
    ``n_lanes`` lanes (the key's bucket, or a mesh rank's share of it)."""

    def __init__(self, key: ExecutableKey, device: torch.device, n_lanes: Optional[int] = None):
        self.key = key
        self.device = device
        self.n_lanes = n_lanes or key.n_lanes

    def run(self, params, chunks, retire_width, lane_ctx, finish):
        """One pass from the zero state through ``chunks``; returns
        ``finish(final state)``."""
        k = self.key
        state = init_state(self.n_lanes, k.sim_cfg, self.device)
        for xs in chunks:
            state = run_chunk(k.predictor, k.sim_cfg, k.use_kernel, params, state, xs,
                              retire_width, lane_ctx)
        return finish(state)


class ChunkGraph:
    """The chunk program of one key on the card: one CUDA graph of a whole
    chunk over static buffers (see the module docstring), on ``n_lanes``
    lanes (the key's bucket, or a mesh rank's share of it).

    A graph entry is not reentrant: ``run`` holds the entry's lock from
    the first copy in to the read-out, so passes from several threads (a
    service's drain thread beside a caller, or beside a dispatch its
    watchdog abandoned) take turns. The build and every pass run with the
    entry's device current, whichever thread calls. ``refills`` counts
    the passes that copied weights into the slots: the first pass, and
    each pass whose weights are not the ones the slots hold (two resident
    models of one kind alternating on the graph refill at every turn).
    """

    def __init__(self, key: ExecutableKey, device: torch.device, params=None,
                 n_lanes: Optional[int] = None):
        L, T, cfg = n_lanes or key.n_lanes, key.chunk, key.sim_cfg
        self.key = key
        self.device = device
        self.lock = threading.Lock()
        self.state = init_state(L, cfg, device)
        self.xs = {k: torch.zeros(shape, dtype=dt, device=device)
                   for k, (shape, dt) in chunk_specs(L, T).items()}
        self.retire_width = torch.full((L,), cfg.retire_width, dtype=torch.int32, device=device)
        self.lane_ctx = torch.full((L,), cfg.ctx_len, dtype=torch.int32, device=device)
        # parameter slots: the building engine's weights first, refilled per pass
        # whenever the entry last ran other weights
        self.params = None if params is None else tree_map(torch.clone, params)
        self._bound = None  # ParamsBinding of the weights the slots hold
        self.refills = 0  # guarded-by: lock

        def body():
            out = run_chunk(key.predictor, cfg, key.use_kernel, self.params, self.state,
                            self.xs, self.retire_width, self.lane_ctx)
            for buf, new in zip(self.state, out):
                if new is not buf:  # the ring step writes the wide planes in place
                    buf.copy_(new)

        with torch.cuda.device(device):
            self.graph = CapturedGraph(body, device)

    def run(self, params, chunks, retire_width, lane_ctx, finish):
        """One pass: zero the state, bind the weights, copy each chunk in
        and replay; returns ``finish(final state)``, read under the lock."""
        with self.lock, torch.cuda.device(self.device):
            if self.params is not None and not (self._bound and self._bound.unchanged(params)):
                _copy_tree(self.params, params)
                self._bound = ParamsBinding(params)
                self.refills += 1
            for buf in self.state:
                buf.zero_()
            self.retire_width.copy_(retire_width)
            self.lane_ctx.copy_(lane_ctx)
            for xs in chunks:
                for name, buf in self.xs.items():
                    buf.copy_(xs[name])
                self.graph.replay()
            return finish(self.state)


def _copy_tree(slots, params):
    """Copy ``params`` into the same-structured tensors ``slots``."""
    if isinstance(slots, dict):
        for k, v in slots.items():
            _copy_tree(v, params[k])
    else:
        slots.copy_(params)


def _program(cache: CompileCache, key: ExecutableKey, device: torch.device, params,
              n_lanes: int):
    """The resident chunk program of ``key`` on ``n_lanes`` lanes from
    ``cache`` (built exactly once per key): a `ChunkGraph` on the card, a
    `ChunkProgram` on the CPU."""
    def build():
        if device.type == "cuda":
            return ChunkGraph(key, device, params, n_lanes)
        return ChunkProgram(key, device, n_lanes)

    prog = cache.get(key, build)
    if device_key(prog.device) != device_key(device):
        raise ValueError(f"the cache holds this key's program on {prog.device}, not on "
                         f"{device}: a cache serves one device")
    return prog


def _run_passes(prog, params, packed: PackedWorkloads, chunk: int, timeit: bool,
                device: torch.device, finish, report):
    """The passes of a ``simulate_many`` call over ``packed``'s lanes: one,
    or under ``timeit`` two over the pack staged on the device up front.
    Each pass returns ``report(prog.run(..., finish))``; the result is a
    list of (that value, the pass's seconds, the time it ended)."""
    # per-lane configs go to the device once; trace chunks stream one at a
    # time from the host (device memory stays O(chunk)) — except under
    # timeit, where the WHOLE pack is staged up front so the timed
    # re-stream measures the simulation, not host-to-device copies
    offsets = range(0, packed.n_steps, chunk)
    staged = [packed_tensors(packed, device, lo, lo + chunk) for lo in offsets] if timeit else None
    host = torch.device("cpu")
    rw = torch.from_numpy(packed.retire_width).to(device)
    lc = torch.from_numpy(packed.lane_ctx).to(device)
    out = []
    for _ in range(2 if timeit else 1):
        t0 = time.perf_counter()
        chunks = staged if staged is not None else (
            packed_tensors(packed, host, lo, lo + chunk) for lo in offsets)
        value = report(prog.run(params, chunks, rw, lc, finish))
        t1 = time.perf_counter()
        out.append((value, t1 - t0, t1))
    return out


def _lanes_of(state: SimState):
    """A pass's per-lane (cycle total, overflow count), on the host."""
    return (state.cur_tick + drain_cycles(state)).cpu(), state.overflow.cpu()


def _lane_slice(packed: PackedWorkloads, lo: int, hi: int) -> PackedWorkloads:
    """Lanes [lo, hi) of a pack (a mesh rank's share)."""
    if (lo, hi) == (0, packed.n_lanes):
        return packed
    return dataclasses.replace(
        packed,
        xs={k: np.ascontiguousarray(v[:, lo:hi]) for k, v in packed.xs.items()},
        workload_id=packed.workload_id[lo:hi], retire_width=packed.retire_width[lo:hi],
        lane_ctx=packed.lane_ctx[lo:hi], lane_steps=packed.lane_steps[lo:hi],
    )


# -- the lane mesh ----------------------------------------------------------

LANE_AXES = ("pod", "data")  # the reference's lane sharding: P(("pod", "data"))

# One exchange at a time in a process: the controller's requests and
# gathers share the default group's point-to-point channels, so two
# threads' calls (a service's drain thread beside a caller) must not
# interleave their messages.
EXCHANGE_LOCK = threading.Lock()


class LaneMesh:
    """Where a ``DeviceMesh`` puts an engine's lanes.

    The lanes split into ``n_shards`` equal slices over the lane axes
    (pod major, data minor, as the reference shards them); a rank's
    ``shard`` is its slice. Ranks that differ only on other axes (the
    ``model`` axis) hold the same slice; of each slice, the rank with
    coordinate 0 on those axes is its ``primary``, whose totals are
    gathered. The ``controller`` is the rank at coordinate 0 on every
    axis. The mesh must span the default process group's world, which
    carries the exchange."""

    def __init__(self, mesh):
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh, got {type(mesh).__name__}")
        names = tuple(mesh.mesh_dim_names or ())
        lane_dims = [names.index(a) for a in LANE_AXES if a in names]
        if not lane_dims:
            raise ValueError(f"the mesh {names} has no lane axis of {LANE_AXES}")
        grid = mesh.mesh
        shape = tuple(grid.shape)
        self.ranks = [int(r) for r in grid.flatten().tolist()]
        if len(self.ranks) != dist.get_world_size():
            raise ValueError(f"the mesh spans {len(self.ranks)} ranks of a world of "
                             f"{dist.get_world_size()}: it must span the whole world")
        self.controller = self.ranks[0]
        self.n_shards = int(np.prod([shape[d] for d in lane_dims]))
        self.shard, self.primary = {}, {}
        for idx, rank in zip(np.ndindex(*shape), self.ranks):
            s = 0
            for d in lane_dims:
                s = s * shape[d] + idx[d]
            self.shard[rank] = s
            self.primary[rank] = all(idx[d] == 0 for d in range(len(shape)) if d not in lane_dims)
        self.followers = self.ranks[1:]


def _send(obj, dst: int) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    dist.send(torch.tensor([len(data)], dtype=torch.int64), dst)
    dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), dst)


def _recv(src: int):
    # only this program's ranks write to the group: the bytes are ours
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src)
    buf = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(buf, src)
    return pickle.loads(buf.numpy().tobytes())


def follow(mesh, device: DeviceLike = None) -> int:
    """Serve the controller of ``mesh`` on this rank until it releases its
    followers (`SimNetEngine.close`, the end of a ``SimNet`` context);
    returns the number of requests served. Programs come from the
    device's process-wide cache.

    A request carries everything a pass needs (the program key, the
    weights, this rank's lane slice of the pack and whether it is its
    slice's primary), so one loop serves every engine of the controller,
    on any mesh over the same world with the same controller. Each pass
    answers the controller once: the slice's per-lane totals (a primary),
    ``None`` (another rank of the slice) or the error that stopped it."""
    lanes = LaneMesh(mesh)
    rank = dist.get_rank()
    if rank == lanes.controller:
        raise ValueError(f"rank {rank} is the controller of this mesh, not a follower")
    dev = resolve_device(device)
    cache = global_cache(dev)
    served = 0
    while True:
        req = _recv(lanes.controller)
        if req is None:
            return served
        passes = 2 if req["timeit"] else 1
        sent = 0

        def report(lane_arrays, primary=req["primary"]):
            nonlocal sent
            _send(lane_arrays if primary else None, lanes.controller)
            sent += 1

        try:
            key, pack = req["key"], req["pack"]
            params = None if req["params"] is None else tree_map(lambda t: t.to(dev), req["params"])
            prog = _program(cache, key, dev, params, pack.n_lanes)
            _run_passes(prog, params, pack, key.chunk, req["timeit"], dev, _lanes_of, report)
        # repro-lint: disable=hygiene-broad-except — any failure goes to the controller, which raises it; this rank keeps serving
        except Exception as e:
            while sent < passes:
                _send({"error": f"rank {rank}: {type(e).__name__}: {e}"}, lanes.controller)
                sent += 1
        served += 1


def run_follower(rank: int, world_size: int, init_method: str, meshes=((None, ("data", "model")),),
                 device_type: str = "cuda", device: DeviceLike = None,
                 timeout_s: float = 1800.0) -> int:
    """A follower process: join the gloo group at ``init_method`` as
    ``rank``, build ``meshes`` ((shape, axes) pairs, shape None for
    `launch.mesh.make_host_mesh`) in the order the controller builds them,
    and `follow` the first until the controller releases it. A target for
    ``multiprocessing`` with the spawn method. ``timeout_s`` bounds every
    wait, an idle follower's for the next request too."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        built = [make_host_mesh(device_type=device_type) if shape is None
                 else make_mesh(shape, axes, device_type) for shape, axes in meshes]
        return follow(built[0], device)
    finally:
        dist.destroy_process_group()


class SimNetEngine:
    def __init__(self, params=None, pcfg: Optional[PredictorConfig] = None,
                 sim_cfg: Optional[SimConfig] = None, mesh=None, use_kernel: bool = False,
                 device: DeviceLike = None, cache: Optional[CompileCache] = None):
        """params=None runs teacher-forced: the programs replay the packed
        DES labels through the identical chunked path. ``mesh`` (a
        ``DeviceMesh`` with a "data" or "pod" axis, this rank its
        controller) splits the lanes over its ranks (see the module
        docstring). ``device`` defaults to ``cuda`` (raises without a GPU);
        the weights move there once. ``cache`` overrides the device's
        process-wide program cache (cold-cache measurements / isolation in
        tests); a cache serves one device."""
        if params is not None and pcfg is None:
            raise ValueError("pcfg is required when params are given")
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.sim_cfg = sim_cfg or (
            SimConfig(ctx_len=pcfg.ctx_len) if pcfg is not None else SimConfig()
        )
        self.mesh = mesh
        self._lanes = None if mesh is None else LaneMesh(mesh)
        self._closed = False
        if self._lanes is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot drive an engine on {self.device}")
            if dist.get_rank() != self._lanes.controller:
                raise ValueError(f"rank {dist.get_rank()} is a follower of this mesh: it calls "
                                 "follow(mesh), and only the controller builds engines")
        self.use_kernel = use_kernel
        self.cache = cache if cache is not None else global_cache(self.device)
        # may be rebound, or updated in place: a resident graph sees either
        self.params = None if params is None else tree_map(lambda t: t.to(self.device), params)

    @property
    def fused(self) -> bool:
        """True when steps run the fused sim-step kernel path."""
        return uses_fused_step(self.pcfg, self.sim_cfg, self.use_kernel)

    # repro-lint: scan-reachable — the per-chunk body
    def _run_chunk(self, state: SimState, xs, retire_width, lane_ctx) -> SimState:
        """One chunk, eagerly: the body every program runs."""
        return run_chunk(self.pcfg, self.sim_cfg, self.use_kernel, self.params, state, xs,
                         retire_width, lane_ctx)

    def close(self) -> None:
        """End the followers' loops of a lane-sharded engine's mesh (the
        controller's last call on it; a second call does nothing); nothing
        without a mesh."""
        if self._lanes is not None and not self._closed:
            self._closed = True
            with EXCHANGE_LOCK:
                for r in self._lanes.followers:
                    _send(None, r)

    # -- resident programs ---------------------------------------------

    def executable_key(self, n_lanes: int, chunk: int) -> ExecutableKey:
        """Cache identity of the chunk program at a (bucketed) shape.
        Weights are absent on purpose: same-architecture models share."""
        return ExecutableKey(
            predictor=self.pcfg,
            sim_cfg=self.sim_cfg,
            n_lanes=n_lanes,
            chunk=chunk,
            mesh=mesh_fingerprint(self.mesh),
            use_kernel=self.use_kernel,
        )

    def _shard_lanes(self, n_lanes: int) -> int:
        """This rank's share of a bucket of ``n_lanes`` (all of it without
        a mesh); a bucket the lane axes do not divide raises."""
        if self._lanes is None:
            return n_lanes
        if n_lanes % self._lanes.n_shards:
            raise ValueError(f"a bucket of {n_lanes} lanes does not split over the mesh's "
                             f"{self._lanes.n_shards} lane shards")
        return n_lanes // self._lanes.n_shards

    def lower(self, n_lanes: int, chunk: int) -> dict:
        """The counterpart of the reference's dry-run lowering. Where the
        reference lowers the chunk program against shape stand-ins for
        XLA to compile, the port traces it: one chunk of this rank's share
        of ``n_lanes`` lanes runs through `run_chunk` on fake tensors
        (``FakeTensorMode``: shapes only, nothing allocated or computed)
        under `runtime.opcount.OpCounter`. Returns the counter's record
        (``flops``, ``bytes_accessed``, ``collectives``,
        ``dot_flops_by_shape``, ``op_histogram``), ``memory_analysis``
        (argument, output and peak-live bytes) and ``trace_seconds``.
        The plain ops run: a kernel cannot run on fake tensors, and its
        `runtime.opcount.region` counts the same work either way."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.runtime import opcount

        lanes = self._shard_lanes(n_lanes)
        mode = FakeTensorMode()
        with mode:
            params = None if self.params is None else tree_map(mode.from_tensor, self.params)
            state = init_state(lanes, self.sim_cfg, self.device)
            xs = {k: torch.zeros(shape, dtype=dtype, device=self.device)
                  for k, (shape, dtype) in chunk_specs(lanes, chunk).items()}
            rw = torch.full((lanes,), self.sim_cfg.retire_width, dtype=torch.int32,
                            device=self.device)
            lc = torch.full((lanes,), self.sim_cfg.ctx_len, dtype=torch.int32, device=self.device)
            res = opcount.analyze(run_chunk, self.pcfg, self.sim_cfg, False, params, state,
                                  xs, rw, lc, fake_mode=mode)
        res.pop("out")
        res["n_lanes"] = lanes
        return res

    def executable(self, n_lanes: int, chunk: int):
        """The resident chunk program from the cache (built exactly once
        per ExecutableKey): a `ChunkGraph` on the card, a `ChunkProgram`
        on the CPU, on this rank's share of the ``n_lanes`` bucket."""
        return _program(self.cache, self.executable_key(n_lanes, chunk), self.device,
                        self.params, self._shard_lanes(n_lanes))

    # -- packed multi-workload path ------------------------------------

    def simulate_many(
        self,
        trace_arrays_list: Sequence[Dict[str, np.ndarray]],
        n_lanes: Union[int, Sequence[int]] = 8,
        chunk: int = 1024,
        cfgs: Union[SimConfig, Sequence[SimConfig], None] = None,
        timeit: bool = False,
    ) -> dict:
        """Simulate many workloads in one packed lane batch, streaming the
        time axis through chunks of ``chunk`` steps of the cache-resident
        program.

        The lane axis is bucketed to the next power of two (dead lanes are
        fully masked and contribute nothing), so nearby lane counts reuse
        one program. timeit=True stages the whole pack on the device and
        streams it a second time, reporting steady-state throughput from
        that pass; the first pass's cost (build or cache hit + staging +
        run) stays in ``first_call_seconds`` either way. On a mesh a pass
        runs on every rank and ends when the controller has gathered its
        totals; the first also sends the requests."""
        t_start = time.perf_counter()
        cache_before = self.cache.counters()
        packed = pack_workloads(
            trace_arrays_list, n_lanes, cfgs if cfgs is not None else self.sim_cfg,
            pad_to=chunk,
        )
        if packed.cfg.ctx_len > self.sim_cfg.ctx_len:
            raise ValueError(
                f"packed ctx_len {packed.cfg.ctx_len} exceeds engine ctx_len "
                f"{self.sim_cfg.ctx_len} (the predictor input width is fixed)"
            )
        n_live = packed.n_lanes
        packed = pad_packed_lanes(packed, lane_bucket(n_live))
        if self.mesh is None:
            prog = self.executable(packed.n_lanes, chunk)

            def finish(state):
                _, cycles, overflow = workload_totals(state, packed)
                return cycles.cpu(), overflow.cpu()  # waits for the device

            passes = _run_passes(prog, self.params, packed, chunk, timeit, self.device, finish,
                                 lambda totals: totals)
        else:
            passes = self._sharded_passes(packed, chunk, timeit)
        (cycles, overflow), dt, _ = passes[-1]
        first_dt = passes[0][2] - t_start  # build/cache hit + staging + first run
        cycles = cycles.numpy().astype(np.float64)
        # Numeric guard: a NaN/Inf anywhere in the predictor's latency
        # stream propagates into these per-workload sums — catch it here,
        # at the batch boundary, before it can poison aggregated CPI.
        # (The chaos "batch.numeric" corrupt trigger poisons the totals
        # directly, flushing this exact path.)
        cycles = faults.fire("batch.numeric", payload=cycles)
        finite = np.isfinite(cycles)
        if not finite.all():
            raise NumericError(np.flatnonzero(~finite), cycles)
        n_instr = packed.n_instructions
        total_instr = int(n_instr.sum())
        return {
            "workload_cycles": cycles,
            "workload_cpi": cycles / np.maximum(n_instr, 1),
            "workload_overflow": overflow.numpy(),
            "n_instructions": n_instr,
            "total_cycles": float(cycles.sum()),
            "total_instructions": total_instr,
            "n_lanes": packed.n_lanes,
            "n_live_lanes": n_live,
            "n_steps": packed.n_steps,  # padded steps actually run
            "n_workloads": packed.n_workloads,
            "throughput_ips": total_instr / dt,
            "seconds": dt,
            "first_call_seconds": first_dt,
            "cache": self.cache.delta_since(cache_before),
        }

    def _sharded_passes(self, packed: PackedWorkloads, chunk: int, timeit: bool):
        """`_run_passes` over the mesh: a request to each follower, this
        rank's slice here, and after each pass the primaries' per-lane
        totals gathered in lane order and reduced to per-workload sums."""
        lanes = self._lanes
        local = self._shard_lanes(packed.n_lanes)
        key = self.executable_key(packed.n_lanes, chunk)
        n_passes = 2 if timeit else 1
        gathered = 0

        def answers():
            """Every follower's answer to one pass: (slices by shard, errors)."""
            nonlocal gathered
            gathered += 1
            parts, errors = {}, []
            for r in lanes.followers:
                msg = _recv(r)
                if isinstance(msg, dict):
                    errors.append(msg["error"])
                elif msg is not None:
                    parts[lanes.shard[r]] = msg
            return parts, errors

        def gather(own):
            """One pass's per-workload sums, this rank's slice first."""
            parts, errors = answers()
            if errors:
                raise RuntimeError(f"a follower of the mesh failed: {'; '.join(errors)}")
            parts[0] = own
            lane_total = torch.cat([parts[s][0] for s in range(lanes.n_shards)])
            lane_overflow = torch.cat([parts[s][1] for s in range(lanes.n_shards)])
            return lane_sums(lane_total, lane_overflow, packed)

        with EXCHANGE_LOCK:
            if lanes.followers:
                # the weights go with every request, so a rebound
                # engine.params reaches every rank at its next call
                host_params = None if self.params is None else tree_map(
                    lambda t: t.detach().cpu(), self.params)
                for r in lanes.followers:
                    s = lanes.shard[r]
                    _send({"key": key, "params": host_params, "timeit": timeit,
                           "primary": lanes.primary[r],
                           "pack": _lane_slice(packed, s * local, (s + 1) * local)}, r)
            try:
                prog = self.executable(packed.n_lanes, chunk)
                return _run_passes(prog, self.params, _lane_slice(packed, 0, local), chunk, timeit,
                                   self.device, _lanes_of, gather)
            finally:
                # every follower answers every pass: read what a failure
                # here left unread, so the next call starts in step
                while gathered < n_passes:
                    answers()

    # -- single-workload convenience (same packed path underneath) -----

    def simulate(self, trace_arrays: Dict[str, np.ndarray], n_lanes: int, chunk: int = 1024,
                 timeit: bool = False):
        res = self.simulate_many([trace_arrays], n_lanes=n_lanes, chunk=chunk, timeit=timeit)
        n = int(res["n_instructions"][0])
        return {
            "total_cycles": float(res["workload_cycles"][0]),
            "cpi": float(res["workload_cpi"][0]),
            "n_instructions": n,
            "throughput_ips": res["throughput_ips"],
            "seconds": res["seconds"],
            "overflow": int(res["workload_overflow"][0]),
        }
