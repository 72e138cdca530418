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
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.core import features as F
from repro_torch.core.predictor import (
    PredictorConfig,
    apply_raw,
    decode_latency,
    make_fused_predict_fn,
)
from repro_torch.core.simulator import (
    SimConfig,
    SimState,
    init_state,
    make_sim_scan,
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
        if uses_fused_step(pcfg, sim_cfg, use_kernel):
            # fused sim-step: assembly + conv trunk in one kernel off the
            # ring buffer. f32 state only: the kernel assembles in f32,
            # while the unfused path rounds the dynamic features through
            # the state dtype — a bf16 state goes to the path below.
            predict_state = make_fused_predict_fn(params, pcfg)
        else:
            def predict(x):
                raw = apply_raw(params, x, pcfg, use_kernel=use_kernel)
                return decode_latency(raw, pcfg)
    step = make_sim_scan(
        predict, sim_cfg,
        retire_width=retire_width, lane_ctx=lane_ctx, emit_outputs=False,
        predict_state_fn=predict_state,
    )
    state, _ = run_steps(step, state, xs)
    return state


class ChunkProgram:
    """The chunk program of one key on the CPU: `run_chunk`, eagerly."""

    def __init__(self, key: ExecutableKey, device: torch.device):
        self.key = key
        self.device = device

    def run(self, params, chunks, retire_width, lane_ctx, finish):
        """One pass from the zero state through ``chunks``; returns
        ``finish(final state)``."""
        k = self.key
        state = init_state(k.n_lanes, k.sim_cfg, self.device)
        for xs in chunks:
            state = run_chunk(k.predictor, k.sim_cfg, k.use_kernel, params, state, xs,
                              retire_width, lane_ctx)
        return finish(state)


class ChunkGraph:
    """The chunk program of one key on the card: one CUDA graph of a whole
    chunk over static buffers (see the module docstring).

    A graph entry is not reentrant: ``run`` holds the entry's lock from
    the first copy in to the read-out, so passes from several threads (a
    service's drain thread beside a caller, or beside a dispatch its
    watchdog abandoned) take turns. The build and every pass run with the
    entry's device current, whichever thread calls. ``refills`` counts
    the passes that copied weights into the slots: the first pass, and
    each pass whose weights are not the ones the slots hold (two resident
    models of one kind alternating on the graph refill at every turn).
    """

    def __init__(self, key: ExecutableKey, device: torch.device, params=None):
        L, T, cfg = key.n_lanes, key.chunk, key.sim_cfg
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


class SimNetEngine:
    def __init__(self, params=None, pcfg: Optional[PredictorConfig] = None,
                 sim_cfg: Optional[SimConfig] = None, use_kernel: bool = False,
                 device: DeviceLike = None, cache: Optional[CompileCache] = None):
        """params=None runs teacher-forced: the programs replay the packed
        DES labels through the identical chunked path. ``device`` defaults
        to ``cuda`` (raises without a GPU); the weights move there once.
        ``cache`` overrides the device's process-wide program cache
        (cold-cache measurements / isolation in tests); a cache serves one
        device."""
        if params is not None and pcfg is None:
            raise ValueError("pcfg is required when params are given")
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.sim_cfg = sim_cfg or (
            SimConfig(ctx_len=pcfg.ctx_len) if pcfg is not None else SimConfig()
        )
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

    # -- resident programs ---------------------------------------------

    def executable_key(self, n_lanes: int, chunk: int) -> ExecutableKey:
        """Cache identity of the chunk program at a (bucketed) shape.
        Weights are absent on purpose: same-architecture models share."""
        return ExecutableKey(
            predictor=self.pcfg,
            sim_cfg=self.sim_cfg,
            n_lanes=n_lanes,
            chunk=chunk,
            mesh=None,
            use_kernel=self.use_kernel,
        )

    def executable(self, n_lanes: int, chunk: int):
        """The resident chunk program from the cache (built exactly once
        per ExecutableKey): a `ChunkGraph` on the card, a `ChunkProgram`
        on the CPU."""
        dev, key = self.device, self.executable_key(n_lanes, chunk)

        def build():
            if dev.type == "cuda":
                return ChunkGraph(key, dev, self.params)
            return ChunkProgram(key, dev)

        prog = self.cache.get(key, build)
        if device_key(prog.device) != device_key(dev):
            raise ValueError(f"the cache holds this key's program on {prog.device}, not on "
                             f"{dev}: a cache serves one device")
        return prog

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
        run) stays in ``first_call_seconds`` either way."""
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
        dev = self.device
        prog = self.executable(packed.n_lanes, chunk)

        # per-lane configs go to the device once; trace chunks stream one at
        # a time from the host (device memory stays O(chunk)) — except under
        # timeit, where the WHOLE pack is staged up front so the timed
        # re-stream measures the simulation, not host-to-device copies
        offsets = range(0, packed.n_steps, chunk)
        staged = [packed_tensors(packed, dev, lo, lo + chunk) for lo in offsets] if timeit else None
        host = torch.device("cpu")
        rw = torch.from_numpy(packed.retire_width).to(dev)
        lc = torch.from_numpy(packed.lane_ctx).to(dev)

        def finish(state):
            _, cycles, overflow = workload_totals(state, packed)
            return cycles.cpu(), overflow.cpu()  # waits for the device

        def one_pass():
            t0 = time.perf_counter()
            chunks = staged if staged is not None else (
                packed_tensors(packed, host, lo, lo + chunk) for lo in offsets)
            cycles, overflow = prog.run(self.params, chunks, rw, lc, finish)
            return time.perf_counter() - t0, cycles, overflow

        dt, cycles, overflow = one_pass()
        first_dt = time.perf_counter() - t_start  # build/cache hit + staging + first run
        if timeit:
            dt, cycles, overflow = one_pass()
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
