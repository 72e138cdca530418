"""Reference out-of-order CPU timing model — the repo's "gem5".

Event-driven per-instruction model of a superscalar OoO core: fetch
bandwidth + icache/ITLB, branch prediction with redirect-on-mispredict,
ROB/IQ/LQ/SQ occupancy stalls, register scoreboard, global issue width,
per-class execution latencies, dcache/DTLB for memory ops, store-to-load
forwarding, memory barriers, in-order bandwidth-limited retirement, and
post-retire store writeback.

This plays both of gem5's roles in the paper: ML training-label generator
and the accuracy baseline the learned simulator is validated against.

The core is implemented as an incremental stepper (`CoreRun`): one call
processes one instruction and advances that core's clock. The classic
single-core `O3Simulator.run` drives a `CoreRun` to completion; the
multicore tick-timeline DES (`des/multicore.py`) interleaves N of them
against shared resources through the `MemPort` seam — L1-miss fills that
reach the L2/memory fabric ask the port how many extra cycles of
contention they pay (zero for the null port used single-core).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np

from simbench.des.branch import make_predictor
from simbench.des.cache import CacheHierarchy
from simbench.des.isa import EXEC_LATENCY, Op
from simbench.des.trace import Trace
from simbench.des.workloads import Program


@dataclasses.dataclass
class O3Config:
    name: str = "default_o3"
    fetch_width: int = 3
    issue_width: int = 8
    retire_width: int = 8
    rob: int = 40
    iq: int = 32
    lq: int = 16
    sq: int = 16
    dispatch_latency: int = 2
    redirect_penalty: int = 3
    forward_latency: int = 2
    store_write_latency: int = 2
    bpred: str = "bimodal"
    caches: Optional[dict] = None

    @property
    def max_context(self) -> int:
        """Max in-flight instructions ≈ frontend + ROB + SQ."""
        return self.rob + self.sq + self.fetch_width * self.dispatch_latency


A64FX_CONFIG = O3Config(
    name="a64fx",
    fetch_width=8,
    issue_width=4,
    retire_width=4,
    rob=128,
    iq=48,
    lq=40,
    sq=24,
    bpred="bimode",
    caches=dict(
        l1i_size=64 * 1024, l1i_assoc=4,
        l1d_size=64 * 1024, l1d_assoc=4, l1d_lat=8,
        l2_size=8 * 1024 * 1024, l2_assoc=16, l2_lat=111,
    ),
)


class MemPort:
    """Timing seam for L1-miss fills that reach the L2/memory fabric.

    `fill(core_id, when, level, write)` is consulted once per fill request
    (icache line fill or dcache load/store miss that left the L1) with the
    cycle the request hits the fabric and the level that served it (2 = L2,
    3 = memory). It returns EXTRA cycles of delay on top of the hierarchy's
    fixed level latency. This null implementation returns 0 — the
    single-core DES is bit-identical with or without it. The multicore DES
    substitutes a bandwidth-limited bus + MSHR arbiter
    (`des.multicore.SharedFabric`) so a fill's latency becomes a function
    of the co-runners' traffic.
    """

    def fill(self, core_id: int, when: int, level: int, write: bool) -> int:
        return 0


class CoreRun:
    """Incremental per-instruction stepper holding one core's full DES
    state. `step()` processes exactly one instruction; `clock` is the
    fetch cycle of the last processed instruction (the core's position on
    the shared tick timeline). Driving a fresh `CoreRun` to completion is
    exactly `O3Simulator.run` — same arithmetic, same results, bit for
    bit — which is what makes the multicore no-sharing mode reproduce
    single-core traces exactly.
    """

    def __init__(
        self,
        cfg: O3Config,
        prog: Program,
        hier: CacheHierarchy,
        bpred,
        core_id: int = 0,
        port: Optional[MemPort] = None,
    ):
        self.cfg = cfg
        self.prog = prog
        self.hier = hier
        self.bpred = bpred
        self.core_id = core_id
        self.port = port if port is not None else MemPort()

        T = prog.n
        self.T = T
        self.fetch_c = np.zeros(T, np.int64)
        self.complete_c = np.zeros(T, np.int64)
        self.retire_c = np.zeros(T, np.int64)
        self.store_done_c = np.zeros(T, np.int64)

        self.mispred = np.zeros(T, bool)
        self.fetch_level = np.zeros(T, np.int8)
        self.fetch_tw = np.zeros((T, 3), np.int8)
        self.fetch_wb = np.zeros((T, 2), np.int8)
        self.data_level = np.zeros(T, np.int8)
        self.data_tw = np.zeros((T, 3), np.int8)
        self.data_wb = np.zeros((T, 3), np.int8)

        self.reg_ready = defaultdict(int)  # register -> cycle value ready
        self.fetch_count = defaultdict(int)  # cycle -> fetched this cycle
        self.issue_count = defaultdict(int)
        self.retire_count = defaultdict(int)

        self.line = hier.cfg["line"]
        self.prev_line = -1
        self.line_ready = 0
        self.redirect_at = 0  # earliest fetch cycle due to branch redirect
        self.last_barrier_done = 0
        self.mem_completes_since_barrier = [0]
        # store-to-load forwarding: addr -> (index, data_ready_cycle)
        self.store_data_ready = {}
        self.loads_idx = []  # indices of loads (LQ occupancy)
        self.stores_idx = []  # indices of stores (SQ occupancy)

        self.prev_fetch = 0
        # timestamp of the core's latest shared-fabric request; dependent-
        # chain cores issue loads up to a ROB-depth of miss latencies ahead
        # of their fetch clock, and the multicore scheduler interleaves on
        # max(fetch clock, mem_clock) so requests reach the shared fabric
        # in near-timestamp order (approximate FCFS arbitration)
        self.mem_clock = 0
        self.i = 0

    @property
    def done(self) -> bool:
        return self.i >= self.T

    @property
    def clock(self) -> int:
        """Fetch cycle of the last processed instruction — the core's
        position on the shared tick timeline (0 before the first step)."""
        return self.prev_fetch

    @property
    def sched_clock(self) -> int:
        """Scheduling key for the multicore interleave: the later of the
        fetch clock and the latest fabric-request timestamp."""
        return self.mem_clock if self.mem_clock > self.prev_fetch else self.prev_fetch

    def step(self) -> int:
        """Process one instruction; returns its fetch cycle."""
        cfg = self.cfg
        hier = self.hier
        prog = self.prog
        i = self.i
        op = int(prog.op[i])
        pc = int(prog.pc[i])

        fetch_c = self.fetch_c
        complete_c = self.complete_c
        retire_c = self.retire_c
        store_done_c = self.store_done_c
        loads_idx = self.loads_idx
        stores_idx = self.stores_idx

        # ---------------- fetch ----------------
        f = max(self.prev_fetch, self.redirect_at)
        # icache / ITLB when crossing a line
        cur_line = pc // self.line
        if cur_line != self.prev_line:
            lvl, tw, wb = hier.fetch_access(pc)
            self.fetch_level[i] = lvl
            self.fetch_tw[i] = tw
            self.fetch_wb[i] = wb
            lat = hier.level_latency(lvl, data=False)
            extra_tw = int((tw == 2).sum()) * hier.cfg["mem_lat"] // 4
            wait = 0
            if lvl >= 2:
                wait = self.port.fill(self.core_id, f, int(lvl), False)
                if f > self.mem_clock:
                    self.mem_clock = f
            self.line_ready = f + lat + extra_tw + wait
            self.prev_line = cur_line
        else:
            self.fetch_level[i] = 1
        f = max(f, self.line_ready)
        # structural stalls: ROB / IQ / LQ / SQ
        if i >= cfg.rob:
            f = max(f, retire_c[i - cfg.rob])
        if i >= cfg.iq:
            f = max(f, complete_c[i - cfg.iq])  # IQ slot frees at issue≈complete
        if op == Op.LOAD and len(loads_idx) >= cfg.lq:
            f = max(f, retire_c[loads_idx[-cfg.lq]])
        if op == Op.STORE and len(stores_idx) >= cfg.sq:
            f = max(f, store_done_c[stores_idx[-cfg.sq]])
        # fetch bandwidth
        while self.fetch_count[f] >= cfg.fetch_width:
            f += 1
        self.fetch_count[f] += 1
        fetch_c[i] = f
        self.prev_fetch = f

        # ---------------- issue ----------------
        ready = f + cfg.dispatch_latency
        for r in prog.src[i]:
            if r >= 0:
                ready = max(ready, self.reg_ready[int(r)])
        if op in (Op.LOAD, Op.STORE):
            ready = max(ready, self.last_barrier_done)
        if op == Op.BARRIER:
            ready = max(ready, max(self.mem_completes_since_barrier))
        while self.issue_count[ready] >= cfg.issue_width:
            ready += 1
        self.issue_count[ready] += 1
        issue = ready

        # ---------------- execute ----------------
        lat = EXEC_LATENCY[Op(op)]
        if op == Op.LOAD:
            addr = int(prog.addr[i])
            lvl, tw, wb = hier.data_access(addr, write=False)
            self.data_level[i] = lvl
            self.data_tw[i] = tw
            self.data_wb[i] = wb
            fwd = self.store_data_ready.get(addr // 8)
            if fwd is not None and fwd[1] > issue:
                lat += cfg.forward_latency
            else:
                lat += hier.level_latency(lvl, data=True)
                lat += int((tw == 2).sum()) * hier.cfg["mem_lat"] // 4
                if lvl >= 2:
                    lat += self.port.fill(self.core_id, issue, int(lvl), False)
                    if issue > self.mem_clock:
                        self.mem_clock = issue
        elif op == Op.STORE:
            addr = int(prog.addr[i])
            lvl, tw, wb = hier.data_access(addr, write=True)
            self.data_level[i] = lvl
            self.data_tw[i] = tw
            self.data_wb[i] = wb
            if lvl >= 2:
                # write-allocate fill occupies the shared fabric (the
                # co-runners feel the bandwidth), but the store itself pays
                # at post-retire writeback, not here — matching the
                # single-core model where stores never wait on the dcache
                self.port.fill(self.core_id, issue, int(lvl), True)
                if issue > self.mem_clock:
                    self.mem_clock = issue
            self.store_data_ready[addr // 8] = (i, issue + 1)
        complete = issue + lat
        complete_c[i] = complete
        for r in prog.dst[i]:
            if r >= 0:
                self.reg_ready[int(r)] = complete
        if op in (Op.LOAD, Op.STORE):
            self.mem_completes_since_barrier.append(complete)
        if op == Op.BARRIER:
            self.last_barrier_done = complete
            self.mem_completes_since_barrier = [0]

        # ---------------- branch resolution ----------------
        if op in (Op.BRANCH, Op.JUMP_IND):
            taken = bool(prog.taken[i])
            if op == Op.JUMP_IND:
                pred = self.bpred.predict(pc)  # BTB-less indirect: harder
                wrong = (pred != taken) or (taken and (pc % 16 == 0))
            else:
                pred = self.bpred.predict(pc)
                wrong = pred != taken
            self.bpred.update(pc, taken)
            if wrong:
                self.mispred[i] = True
                self.redirect_at = complete + cfg.redirect_penalty

        # ---------------- retire (in-order, bw-limited) ----------------
        r = max(complete, retire_c[i - 1] if i else 0)
        while self.retire_count[r] >= cfg.retire_width:
            r += 1
        self.retire_count[r] += 1
        retire_c[i] = r

        if op == Op.STORE:
            sd = r + cfg.store_write_latency
            if stores_idx:
                sd = max(sd, store_done_c[stores_idx[-1]])  # SQ drains in order
            store_done_c[i] = sd
            stores_idx.append(i)
        if op == Op.LOAD:
            loads_idx.append(i)

        # periodic cleanup of the bandwidth dicts
        if i % 4096 == 4095:
            horizon = fetch_c[i] - 64
            for d in (self.fetch_count, self.issue_count, self.retire_count):
                for k in [k for k in d if k < horizon]:
                    del d[k]
            if len(self.store_data_ready) > 65536:
                self.store_data_ready.clear()
            if len(self.mem_completes_since_barrier) > 65536:
                self.mem_completes_since_barrier = [
                    max(self.mem_completes_since_barrier)
                ]

        self.i = i + 1
        return int(f)

    def finish(self) -> Trace:
        """Assemble the per-core Trace once every instruction has stepped."""
        assert self.done, "finish() before all instructions stepped"
        prog = self.prog
        fetch_lat = np.diff(self.fetch_c, prepend=self.fetch_c[0])
        exec_lat = self.complete_c - self.fetch_c
        store_lat = np.where(
            prog.op == Op.STORE, self.store_done_c - self.fetch_c, 0
        )
        return Trace(
            name=prog.name,
            pc=prog.pc, op=prog.op, src=prog.src, dst=prog.dst, addr=prog.addr,
            mispred=self.mispred,
            fetch_level=self.fetch_level, fetch_tw=self.fetch_tw,
            fetch_wb=self.fetch_wb,
            data_level=self.data_level, data_tw=self.data_tw,
            data_wb=self.data_wb,
            fetch_lat=fetch_lat.astype(np.int64),
            exec_lat=exec_lat.astype(np.int64),
            store_lat=store_lat.astype(np.int64),
        )


class O3Simulator:
    def __init__(self, cfg: O3Config = O3Config()):
        self.cfg = cfg
        self.hier = CacheHierarchy(cfg.caches)
        self.bpred = make_predictor(cfg.bpred)

    def run(self, prog: Program, progress: bool = False) -> Trace:
        self.hier.reset()
        self.bpred.reset()
        core = CoreRun(self.cfg, prog, self.hier, self.bpred)
        while not core.done:
            core.step()
        return core.finish()
