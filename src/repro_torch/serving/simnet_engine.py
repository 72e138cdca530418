"""SimNet parallel-simulation engine (paper §3.3) — the port of
``repro.serving.simnet_engine``.

``simulate_many`` packs lanes from many workloads × SimConfigs into one
lane batch (per-lane workload ids, validity masks for ragged trace
lengths, per-lane retire width / context capacity) and streams the time
axis through chunks, with the lane count rounded up to a power of two
(dead lanes are masked and add exactly nothing). ``simulate`` is the
single-workload case of the same path. Each chunk is a Python loop of
steps on the engine's device; the step's predictor is chosen by the same
kernel gate as the reference's:

  ring layout + c3 + f32 state + ``use_kernel`` → the fused sim-step kernel
    (`kernels.ops.fused_step`: input assembly + trunk off the ring state);
  otherwise ``use_kernel`` → the trunk kernel (`kernels.ops.cnn_trunk`)
    on the assembled input (roll layout, bf16 state); else plain torch.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
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
from repro_torch.serving.compile_cache import lane_bucket


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


def _params_to(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


class SimNetEngine:
    def __init__(self, params=None, pcfg: Optional[PredictorConfig] = None,
                 sim_cfg: Optional[SimConfig] = None, use_kernel: bool = False,
                 device: DeviceLike = None):
        """params=None runs teacher-forced: the loop replays the packed DES
        labels through the identical chunked path. ``device`` defaults to
        ``cuda`` (raises without a GPU); the weights move there once."""
        if params is not None and pcfg is None:
            raise ValueError("pcfg is required when params are given")
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.sim_cfg = sim_cfg or (
            SimConfig(ctx_len=pcfg.ctx_len) if pcfg is not None else SimConfig()
        )
        self.use_kernel = use_kernel
        self.params = None if params is None else _params_to(params, self.device)

    @property
    def fused(self) -> bool:
        """True when steps run the fused sim-step kernel path."""
        return (self.pcfg is not None and self.use_kernel
                and self.sim_cfg.layout == "ring" and self.pcfg.kind == "c3"
                and self.sim_cfg.state_dtype == "float32")

    # repro-lint: scan-reachable — the per-chunk body
    def _run_chunk(self, state: SimState, xs, retire_width, lane_ctx) -> SimState:
        predict = predict_state = None
        p = self.params
        if self.pcfg is not None:
            if self.fused:
                # fused sim-step: assembly + conv trunk in one kernel off the
                # ring buffer. f32 state only: the kernel assembles in f32,
                # while the unfused path rounds the dynamic features through
                # the state dtype — a bf16 state goes to the path below.
                predict_state = make_fused_predict_fn(p, self.pcfg)
            else:
                def predict(x):
                    raw = apply_raw(p, x, self.pcfg, use_kernel=self.use_kernel)
                    return decode_latency(raw, self.pcfg)
        step = make_sim_scan(
            predict, self.sim_cfg,
            retire_width=retire_width, lane_ctx=lane_ctx, emit_outputs=False,
            predict_state_fn=predict_state,
        )
        state, _ = run_steps(step, state, xs)
        return state

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
        time axis through chunks of ``chunk`` steps.

        The lane axis is bucketed to the next power of two (dead lanes are
        fully masked and contribute nothing). timeit=True stages the whole
        pack on the device and streams it a second time, reporting
        steady-state throughput from that pass; the first pass's cost
        (staging + run) stays in ``first_call_seconds`` either way."""
        t_start = time.perf_counter()
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

        # per-lane configs go to the device once; trace chunks stream one at
        # a time (device memory stays O(chunk)) — except under timeit, where
        # the WHOLE pack is staged up front so the timed re-stream measures
        # the simulation, not host-to-device copies
        def stage(lo):
            return packed_tensors(packed, dev, lo, lo + chunk)

        offsets = range(0, packed.n_steps, chunk)
        staged = [stage(lo) for lo in offsets] if timeit else None
        rw = torch.from_numpy(packed.retire_width).to(dev)
        lc = torch.from_numpy(packed.lane_ctx).to(dev)

        def one_pass():
            t0 = time.perf_counter()
            state = init_state(packed.n_lanes, self.sim_cfg, dev)
            for xs in staged if staged is not None else (stage(lo) for lo in offsets):
                state = self._run_chunk(state, xs, rw, lc)
            _, cycles, overflow = workload_totals(state, packed)
            cycles, overflow = cycles.cpu(), overflow.cpu()  # waits for the device
            return time.perf_counter() - t0, cycles, overflow

        dt, cycles, overflow = one_pass()
        first_dt = time.perf_counter() - t_start  # staging + first run
        if timeit:
            dt, cycles, overflow = one_pass()
        cycles = cycles.numpy().astype(np.float64)
        # Numeric guard: a NaN/Inf anywhere in the predictor's latency
        # stream propagates into these per-workload sums — catch it here,
        # at the batch boundary, before it can poison aggregated CPI.
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
            "cache": {"hits": 0, "misses": 0, "compile_seconds": 0.0},
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
