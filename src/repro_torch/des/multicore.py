"""Tick-timeline multicore DES: N O3 cores against shared resources.

Every trace the single-core DES (`des/o3.py`) produces is contention-free:
one core, private caches, a memory system with fixed latencies. This
module interleaves N `CoreRun` steppers on one shared tick timeline so a
core's memory latency becomes a function of its co-runners:

- **Shared L2** — one `Cache` instance stands behind every core's L1s, so
  a streaming co-runner evicts a neighbour's working set (hit-rate delta
  shows up in `data_level`/`fetch_level`, i.e. in the predictor's inputs).
- **Bandwidth-limited bus** — every L1-miss fill serialises through one
  bus (`bus_cycles_per_fill` busy cycles each); a fill issued while the
  bus is busy queues and the requester pays the queuing delay.
- **MSHR-style outstanding-miss limit** — at most `mshrs` memory-level
  misses in flight; when all miss registers are busy the next miss waits
  for the oldest to complete.

Scheduling is deterministic: repeatedly step the core with the smallest
clock (last fetch cycle), ties broken by core id. Cores interact only
through the shared L2 state and the `SharedFabric` timing port, both of
which are pure functions of the (deterministic) step order.

Ground truth stays per-core `Trace`s with the exact single-core schema —
the feature pipeline, training, and the packed engine consume them
unchanged. `contention_report` additionally runs each program solo on an
identical isolated core and assembles a `ContentionReport` (solo vs
co-run CPI, bus occupancy, shared-L2 hit deltas).

With sharing disabled (`MulticoreConfig.isolated()`: private L2s,
zero-cost bus, unlimited MSHRs) each core is exactly `O3Simulator.run` —
the traces are bit-identical, which the golden tests pin.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.des.branch import make_predictor
from repro_torch.des.cache import Cache, CacheHierarchy
from repro_torch.des.o3 import CoreRun, MemPort, O3Config
from repro_torch.des.trace import Trace
from repro_torch.des.workloads import Program


@dataclasses.dataclass
class MulticoreConfig:
    """Shared-resource knobs. Core count comes from the program list."""

    name: str = "mc"
    shared_l2: bool = True
    # bus busy cycles per L1-miss fill; 0 = infinite bandwidth (no bus)
    bus_cycles_per_fill: int = 6
    # max outstanding memory-level misses; 0 = unlimited
    mshrs: int = 4

    @classmethod
    def isolated(cls) -> "MulticoreConfig":
        """Sharing disabled: private L2s, free bus, unlimited MSHRs.
        N cores in this mode reproduce N single-core runs bit-identically."""
        return cls(name="iso", shared_l2=False, bus_cycles_per_fill=0, mshrs=0)

    @property
    def cache_tag(self) -> str:
        """Stable tag for trace-cache filenames."""
        l2 = "s" if self.shared_l2 else "p"
        return f"{l2}b{self.bus_cycles_per_fill}m{self.mshrs}"


class _SlottedLimiter:
    """Capacity-limited timeline for out-of-order request streams.

    The one-pass event-driven cores issue fill requests out of global
    time order: a dependent-chain core's data accesses carry issue
    timestamps up to a ROB-depth of miss latencies ahead of its fetch
    clock, while a streaming co-runner's stay near its clock. A single
    monotone `next_free` cursor would therefore charge early-timestamped
    requests for reservations made "in the future" by a co-runner —
    queueing delay without bandwidth pressure. Instead the timeline is
    cut into fixed windows with a booking capacity each; a request books
    the first window at-or-after its own timestamp with spare capacity
    and pays only the distance to it. With window == service time and
    capacity 1 this is exact interval allocation for a serial bus; with
    window == miss latency and capacity M it caps in-flight misses
    MSHR-style (at most M misses starting per latency window).
    """

    def __init__(self, window: int, capacity: int):
        self.window = window
        self.capacity = capacity
        self.booked: dict = {}  # window index -> bookings

    def book(self, when: int) -> int:
        """Reserve a slot at or after `when`; returns the wait in cycles."""
        b = int(when) // self.window
        while self.booked.get(b, 0) >= self.capacity:
            b += 1
        self.booked[b] = self.booked.get(b, 0) + 1
        start = b * self.window
        return start - int(when) if start > when else 0


class SharedFabric(MemPort):
    """Bandwidth-limited bus + MSHR arbiter shared by all cores.

    `fill` charges a request arriving at cycle `when`: book a bus slot
    (every L1-miss fill serialises through the bus), then — memory-level
    misses only — a miss-register slot. Returns the total extra cycles;
    the fixed L2/memory latency itself stays in
    `CacheHierarchy.level_latency`.
    """

    def __init__(self, mc: MulticoreConfig, mem_lat: int):
        self.mc = mc
        self.mem_lat = mem_lat
        self.busy_cycles = 0
        self.queue_cycles = 0
        self.mshr_wait_cycles = 0
        self.fills = 0
        self.fills_per_core: dict = {}
        self._bus = (
            _SlottedLimiter(mc.bus_cycles_per_fill, 1)
            if mc.bus_cycles_per_fill > 0
            else None
        )
        self._mshr = _SlottedLimiter(mem_lat, mc.mshrs) if mc.mshrs > 0 else None

    def fill(self, core_id: int, when: int, level: int, write: bool) -> int:
        t = int(when)
        extra = 0
        self.fills += 1
        self.fills_per_core[core_id] = self.fills_per_core.get(core_id, 0) + 1
        if self._bus is not None:
            wait = self._bus.book(t)
            self.queue_cycles += wait
            self.busy_cycles += self.mc.bus_cycles_per_fill
            extra += wait
            t += wait
        if level >= 3 and self._mshr is not None:
            wait = self._mshr.book(t)
            self.mshr_wait_cycles += wait
            extra += wait
        return extra

    def stats(self, makespan: int) -> dict:
        return dict(
            fills=self.fills,
            fills_per_core={int(k): int(v) for k, v in self.fills_per_core.items()},
            busy_cycles=int(self.busy_cycles),
            queue_cycles=int(self.queue_cycles),
            mshr_wait_cycles=int(self.mshr_wait_cycles),
            occupancy=float(self.busy_cycles) / float(makespan) if makespan else 0.0,
        )


class _CountingCache:
    """Per-core view of a (possibly shared) cache that counts this core's
    accesses/hits. Quacks like `Cache` for `CacheHierarchy`'s purposes."""

    def __init__(self, cache: Cache):
        self.cache = cache
        self.accesses = 0
        self.hits = 0

    def access(self, addr: int, write: bool = False):
        hit, wb = self.cache.access(addr, write)
        self.accesses += 1
        self.hits += int(hit)
        return hit, wb

    def reset(self):
        # CacheHierarchy.reset() calls this once per core before the run;
        # resetting a shared cache several times at t=0 is idempotent.
        self.cache.reset()
        self.accesses = 0
        self.hits = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0


@dataclasses.dataclass
class ContentionReport:
    """Solo-vs-co-run deltas per core plus shared-fabric stats."""

    mix: str
    n_cores: int
    mc: dict  # MulticoreConfig as dict
    cores: List[dict]  # per core: name, solo/corun cycles+CPI, slowdown, L2 hit rates
    bus: dict  # occupancy, queue_cycles, mshr_wait_cycles, fills
    makespan: int  # max per-core total cycles of the co-run

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def slowdowns(self) -> List[float]:
        return [c["slowdown"] for c in self.cores]


class MulticoreSim:
    """Interleaves N `CoreRun` steppers against shared L2 + bus + MSHRs."""

    def __init__(
        self,
        o3: O3Config | Sequence[O3Config] | None = None,
        mc: MulticoreConfig | None = None,
    ):
        self.o3 = o3 if o3 is not None else O3Config()
        self.mc = mc if mc is not None else MulticoreConfig()

    def _core_cfgs(self, n: int) -> List[O3Config]:
        if isinstance(self.o3, O3Config):
            return [self.o3] * n
        cfgs = list(self.o3)
        if len(cfgs) != n:
            raise ValueError(
                f"got {len(cfgs)} O3Configs for {n} programs; pass one per "
                f"core or a single config shared by all"
            )
        return cfgs

    def run(self, progs: Sequence[Program]) -> Tuple[List[Trace], dict]:
        """Run the co-schedule to completion.

        Returns (per-core traces — single-core `Trace` schema, in program
        order — and a stats dict with bus + per-core shared-L2 counters).
        """
        n = len(progs)
        if n == 0:
            raise ValueError("need at least one program")
        cfgs = self._core_cfgs(n)
        mc = self.mc

        port: MemPort
        shared_l2: Optional[Cache] = None
        if mc.shared_l2:
            # shared L2 geometry comes from core 0's cache config
            base = CacheHierarchy(cfgs[0].caches).cfg
            shared_l2 = Cache(base["l2_size"], base["l2_assoc"], base["line"], "l2s")
        if mc.bus_cycles_per_fill > 0 or mc.mshrs > 0:
            mem_lat = CacheHierarchy(cfgs[0].caches).cfg["mem_lat"]
            port = SharedFabric(mc, mem_lat)
        else:
            port = MemPort()

        cores: List[CoreRun] = []
        l2_views: List[_CountingCache] = []
        for i, (cfg, prog) in enumerate(zip(cfgs, progs)):
            hier = CacheHierarchy(cfg.caches)
            view = _CountingCache(shared_l2 if shared_l2 is not None else hier.l2)
            hier.l2 = view  # type: ignore[assignment]
            hier.reset()
            l2_views.append(view)
            cores.append(
                CoreRun(cfg, prog, hier, make_predictor(cfg.bpred), core_id=i, port=port)
            )
        # per-core counters survive the per-core resets above
        for v in l2_views:
            v.accesses = 0
            v.hits = 0

        active = list(cores)
        while active:
            # deterministic min-clock interleave, ties broken by core id;
            # sched_clock (fetch clock advanced to the latest fabric
            # request) keeps fill requests in near-timestamp order at the
            # fabric, so slot arbitration approximates FCFS
            best = active[0]
            for c in active[1:]:
                if (c.sched_clock, c.core_id) < (best.sched_clock, best.core_id):
                    best = c
            best.step()
            if best.done:
                active.remove(best)

        traces = [c.finish() for c in cores]
        makespan = max(int(t.total_cycles) for t in traces)
        stats = dict(
            makespan=makespan,
            l2=[
                dict(accesses=v.accesses, hits=v.hits, hit_rate=v.hit_rate)
                for v in l2_views
            ],
            bus=port.stats(makespan) if isinstance(port, SharedFabric) else None,
        )
        return traces, stats


def run_corun(
    progs: Sequence[Program],
    o3: O3Config | Sequence[O3Config] | None = None,
    mc: MulticoreConfig | None = None,
) -> Tuple[List[Trace], dict]:
    """Convenience wrapper: co-run `progs` and return (traces, stats)."""
    return MulticoreSim(o3, mc).run(progs)


def contention_report(
    progs: Sequence[Program],
    o3: O3Config | Sequence[O3Config] | None = None,
    mc: MulticoreConfig | None = None,
    mix: str = "custom",
) -> Tuple[List[Trace], ContentionReport]:
    """Co-run `progs`, then run each solo on an identical isolated core,
    and assemble the solo-vs-co-run `ContentionReport`.

    Returns (co-run traces, report). The solo runs use a 1-core
    `MulticoreSim` with sharing disabled, i.e. exactly `O3Simulator.run`.
    """
    mc = mc if mc is not None else MulticoreConfig()
    sim = MulticoreSim(o3, mc)
    corun_traces, corun_stats = sim.run(progs)

    cfgs = sim._core_cfgs(len(progs))
    iso = MulticoreConfig.isolated()
    cores = []
    for i, (cfg, prog, tr) in enumerate(zip(cfgs, progs, corun_traces)):
        solo_tr, solo_stats = MulticoreSim(cfg, iso).run([prog])
        solo = solo_tr[0]
        solo_cyc = int(solo.total_cycles)
        corun_cyc = int(tr.total_cycles)
        cores.append(
            dict(
                name=prog.name,
                n=int(prog.n),
                solo_cycles=solo_cyc,
                corun_cycles=corun_cyc,
                solo_cpi=float(solo.cpi),
                corun_cpi=float(tr.cpi),
                slowdown=corun_cyc / solo_cyc if solo_cyc else 0.0,
                l2_hit_rate_solo=float(solo_stats["l2"][0]["hit_rate"]),
                l2_hit_rate_corun=float(corun_stats["l2"][i]["hit_rate"]),
            )
        )
    report = ContentionReport(
        mix=mix,
        n_cores=len(progs),
        mc=dataclasses.asdict(mc),
        cores=cores,
        bus=corun_stats["bus"] or {},
        makespan=int(corun_stats["makespan"]),
    )
    return corun_traces, report
