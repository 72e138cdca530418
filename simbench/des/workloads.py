"""Synthetic benchmark generators — the SPEC-CPU-2017 stand-in.

Each generator emits a full instruction trace (numpy struct-of-arrays):
pc, op_class, src/dst regs, memory address, branch taken/target. Styles
cover the behavioural spectrum the paper evaluates on: compute-bound,
memory-streaming, pointer-chasing, branchy, loopy and phased mixtures.

Training uses 4 benchmarks ("ml" set); evaluation uses all, including 8
held-out ones with different seeds and parameters — preserving the paper's
train-on-4 / evaluate-on-25(21-unseen) generalization methodology.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from simbench.des.isa import MAX_DST, MAX_SRC, Op


@dataclasses.dataclass
class Program:
    name: str
    pc: np.ndarray  # (T,) int64
    op: np.ndarray  # (T,) int8
    src: np.ndarray  # (T, MAX_SRC) int16, -1 pad
    dst: np.ndarray  # (T, MAX_DST) int16, -1 pad
    addr: np.ndarray  # (T,) int64, 0 for non-mem
    taken: np.ndarray  # (T,) bool (branches)

    @property
    def n(self):
        return len(self.pc)


def _empty(T):
    return dict(
        pc=np.zeros(T, np.int64),
        op=np.zeros(T, np.int8),
        src=np.full((T, MAX_SRC), -1, np.int16),
        dst=np.full((T, MAX_DST), -1, np.int16),
        addr=np.zeros(T, np.int64),
        taken=np.zeros(T, bool),
    )


def _finish(name, d):
    return Program(name=name, **d)


def _rand_regs(rng, row, n_src, n_dst, reg_pool):
    src = rng.choice(reg_pool, size=n_src, replace=True)
    dst = rng.choice(reg_pool, size=n_dst, replace=True)
    row_src = np.full(MAX_SRC, -1, np.int16)
    row_dst = np.full(MAX_DST, -1, np.int16)
    row_src[:n_src] = src
    row_dst[:n_dst] = dst
    return row_src, row_dst


def gen_stream(T, seed=0, stride=64, working_set=1 << 22, alu_per_load=2):
    """Streaming loads with light ALU — memory-bandwidth bound."""
    rng = np.random.default_rng(seed)
    d = _empty(T)
    pool = np.arange(4, 36)
    pc0 = 0x400000
    a = 0x10000000
    body = alu_per_load + 2
    for i in range(T):
        phase = i % body
        d["pc"][i] = pc0 + 4 * (i % (body * 8))
        if phase == 0:
            d["op"][i] = Op.LOAD
            d["addr"][i] = a % working_set + 0x10000000
            a += stride
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 1, 1, pool)
        elif phase == body - 1 and i % (body * 8) == body * 8 - 1:
            d["op"][i] = Op.BRANCH
            d["taken"][i] = True
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 1, 0, pool)
        else:
            d["op"][i] = Op.INT_ALU
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 1, pool)
    return _finish(f"stream_s{seed}", d)


def gen_compute(T, seed=0, chain_len=4, fp_ratio=0.7, div_ratio=0.05):
    """FP dependency chains — execution-latency bound."""
    rng = np.random.default_rng(seed)
    d = _empty(T)
    pc0 = 0x400000
    chain_reg = 4
    for i in range(T):
        d["pc"][i] = pc0 + 4 * (i % 256)
        r = rng.random()
        if r < div_ratio:
            op = Op.FP_DIV if rng.random() < fp_ratio else Op.INT_DIV
        elif r < fp_ratio:
            op = Op.FP_MUL if rng.random() < 0.5 else Op.FP_ALU
        else:
            op = Op.INT_MUL if rng.random() < 0.3 else Op.INT_ALU
        d["op"][i] = op
        in_chain = (i % chain_len) != 0
        src = np.full(MAX_SRC, -1, np.int16)
        dst = np.full(MAX_DST, -1, np.int16)
        src[0] = chain_reg if in_chain else int(rng.integers(8, 40))
        src[1] = int(rng.integers(8, 40))
        dst[0] = chain_reg
        d["src"][i], d["dst"][i] = src, dst
        if i % 128 == 127:
            d["op"][i] = Op.BRANCH
            d["taken"][i] = True
    return _finish(f"compute_s{seed}", d)


def gen_pointer_chase(T, seed=0, working_set=1 << 24, line=64):
    """Random dependent loads over a big working set — miss-latency bound."""
    rng = np.random.default_rng(seed)
    d = _empty(T)
    pc0 = 0x400000
    n_lines = working_set // line
    for i in range(T):
        d["pc"][i] = pc0 + 4 * (i % 64)
        if i % 3 == 0:
            d["op"][i] = Op.LOAD
            d["addr"][i] = 0x20000000 + int(rng.integers(0, n_lines)) * line
            src = np.full(MAX_SRC, -1, np.int16)
            dst = np.full(MAX_DST, -1, np.int16)
            src[0] = 4  # chase chain through r4
            dst[0] = 4
            d["src"][i], d["dst"][i] = src, dst
        else:
            d["op"][i] = Op.INT_ALU
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 1, np.arange(8, 32))
    return _finish(f"chase_s{seed}", d)


def gen_branchy(T, seed=0, predictability=0.7, n_branch_sites=64):
    """Branch-heavy code with tunable predictability — frontend bound."""
    rng = np.random.default_rng(seed)
    d = _empty(T)
    pc0 = 0x400000
    bias = rng.random(n_branch_sites)  # per-site taken bias
    for i in range(T):
        site = int(rng.integers(0, n_branch_sites))
        if i % 4 == 3:
            d["op"][i] = Op.BRANCH
            d["pc"][i] = pc0 + 4 * site
            p = bias[site] * predictability + 0.5 * (1 - predictability)
            d["taken"][i] = rng.random() < p
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 0, np.arange(8, 32))
        else:
            d["op"][i] = Op.INT_ALU
            d["pc"][i] = pc0 + 0x1000 + 4 * (i % 512)
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 1, np.arange(8, 32))
    return _finish(f"branchy_s{seed}", d)


def gen_loop(T, seed=0, body=24, stores_every=6, working_set=1 << 16):
    """Tight loop with stores — icache-friendly, store-queue pressure."""
    rng = np.random.default_rng(seed)
    d = _empty(T)
    pc0 = 0x400000
    a = 0
    pool = np.arange(4, 28)
    for i in range(T):
        j = i % body
        d["pc"][i] = pc0 + 4 * j
        if j == body - 1:
            d["op"][i] = Op.BRANCH
            d["taken"][i] = True
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 1, 0, pool)
        elif j % stores_every == stores_every - 1:
            d["op"][i] = Op.STORE
            d["addr"][i] = 0x30000000 + (a % working_set)
            a += 8
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 0, pool)
        elif j % stores_every == 0:
            d["op"][i] = Op.LOAD
            d["addr"][i] = 0x30000000 + ((a + 64) % working_set)
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 1, 1, pool)
        else:
            op = Op.VEC_ALU if j % 5 == 2 else Op.INT_ALU
            d["op"][i] = op
            d["src"][i], d["dst"][i] = _rand_regs(rng, i, 2, 1, pool)
    return _finish(f"loop_s{seed}", d)


def gen_phased(T, seed=0):
    """Concatenated phases from different generators (paper Fig. 6 style)."""
    rng = np.random.default_rng(seed)
    gens = [gen_stream, gen_compute, gen_branchy, gen_loop, gen_pointer_chase]
    n_phases = 5
    per = T // n_phases
    parts = []
    for p in range(n_phases):
        g = gens[int(rng.integers(0, len(gens)))]
        parts.append(g(per, seed=seed * 97 + p))
    d = {
        k: np.concatenate([getattr(x, k) for x in parts])
        for k in ("pc", "op", "src", "dst", "addr", "taken")
    }
    return _finish(f"phased_s{seed}", d)


# --- the benchmark suite -----------------------------------------------
# 4 "ML" benchmarks (training-data generation) + 8 evaluation-only.
ML_BENCHMARKS: Dict[str, Callable[[int], Program]] = {
    "mlb_stream": lambda T: gen_stream(T, seed=1),
    "mlb_compute": lambda T: gen_compute(T, seed=2),
    "mlb_branchy": lambda T: gen_branchy(T, seed=3, predictability=0.8),
    "mlb_mixed": lambda T: gen_phased(T, seed=4),
}

SIM_BENCHMARKS: Dict[str, Callable[[int], Program]] = {
    "sim_stream2": lambda T: gen_stream(T, seed=11, stride=128, working_set=1 << 23),
    "sim_compute2": lambda T: gen_compute(T, seed=12, chain_len=8, fp_ratio=0.9),
    "sim_chase": lambda T: gen_pointer_chase(T, seed=13),
    # 2MB working set straddles the Table 5 L2 sweep (256KB < ws ≤ 4MB), so
    # swept sizes actually change the hit rate — 16MB thrashes every size
    # and 256KB fits in all of them (both give size-independent cycles)
    "sim_chase_mid": lambda T: gen_pointer_chase(T, seed=21, working_set=1 << 21),
    "sim_chase_small": lambda T: gen_pointer_chase(T, seed=14, working_set=1 << 18),
    "sim_branchy_hard": lambda T: gen_branchy(T, seed=15, predictability=0.3),
    "sim_branchy_easy": lambda T: gen_branchy(T, seed=16, predictability=0.95),
    "sim_loop": lambda T: gen_loop(T, seed=17),
    "sim_phased": lambda T: gen_phased(T, seed=18),
}

ALL_BENCHMARKS = {**ML_BENCHMARKS, **SIM_BENCHMARKS}


def get_benchmark(name: str, T: int) -> Program:
    try:
        gen = ALL_BENCHMARKS[name]
    except KeyError:
        raise ValueError(
            f"unknown benchmark {name!r}; available: "
            f"{', '.join(sorted(ALL_BENCHMARKS))}"
        ) from None
    return gen(T)


# --- multicore co-run mixes --------------------------------------------
# Each mix is a list of per-core (length_multiplier, generator) slots;
# `get_mix` instantiates one program per core with a distinct
# deterministic seed, and cycles the slots when asked for more cores than
# the mix's natural width (so `--multicore 4 --mix mix_stream_chase`
# gives stream/chase/stream/chase with four distinct seeds). Length
# multipliers balance per-core *cycle* time: a CPI-0.8 compute core gets
# more instructions than a CPI-24 chase core, so co-runners actually
# overlap instead of the fast one finishing during the slow one's warmup
# (this is also what makes co-run trace packs genuinely mixed-length).
# The stream+chase pairing is the textbook streamer/victim scenario: the
# chase's 128KB working set is resident in the shared L2 when run solo,
# and the streaming co-runner continuously evicts it; chase_sym uses 1MB
# each so two cores oversubscribe the 1MB L2.
_MIX_SPECS: Dict[str, List] = {
    "mix_stream_chase": [
        (4, lambda T, s: gen_stream(T, seed=s, working_set=1 << 22)),
        (1, lambda T, s: gen_pointer_chase(T, seed=s, working_set=1 << 17)),
    ],
    "mix_compute_stream": [
        (5, lambda T, s: gen_compute(T, seed=s)),
        (1, lambda T, s: gen_stream(T, seed=s, working_set=1 << 22)),
    ],
    # symmetric chase×N (natural width 2; widen with n_cores)
    "mix_chase_sym": [
        (1, lambda T, s: gen_pointer_chase(T, seed=s, working_set=1 << 20)),
        (1, lambda T, s: gen_pointer_chase(T, seed=s, working_set=1 << 20)),
    ],
}

MULTICORE_MIXES: List[str] = sorted(_MIX_SPECS)


def _relocate(prog: Program, core_idx: int) -> Program:
    """Shift a core's address space so co-runners are disjoint in the
    shared L2 — contention must come from capacity/bandwidth, not from
    accidentally prefetching a sibling's lines. Offsets are multiples of
    every cache's (n_sets × line), so the program's own set-mapping and
    hit/miss structure are unchanged; 0x05000000 is not commensurate with
    the generators' 0x10000000-spaced data bases, so no two cores'
    regions collide, and 8 cores stay inside the int32 address-key budget
    (`core.features.address_keys`)."""
    if core_idx == 0:
        return prog
    prog.addr = np.where(prog.addr > 0, prog.addr + core_idx * 0x05000000, 0)
    prog.pc = prog.pc + core_idx * 0x00100000
    return prog


def get_mix(name: str, T: int, n_cores: int | None = None, seed: int = 0) -> List[Program]:
    """Instantiate a co-run mix: one `Program` per core, deterministic in
    (name, T, n_cores, seed). `T` is the base per-core instruction count;
    each slot scales it by its length multiplier. Different `seed`s give
    disjoint program instances — training sets and held-out eval sets of
    the same mix."""
    try:
        spec = _MIX_SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown mix {name!r}; available: {', '.join(MULTICORE_MIXES)}"
        ) from None
    n = n_cores if n_cores else len(spec)
    if n < 1:
        raise ValueError(f"n_cores must be >= 1, got {n}")
    if n > 8:
        raise ValueError(
            f"n_cores must be <= 8 (int32 address-key budget), got {n}"
        )
    progs = []
    for i in range(n):
        mult, fn = spec[i % len(spec)]
        progs.append(_relocate(fn(mult * T, 1000 + seed * 131 + i * 7), i))
    return progs
