"""Lightweight history-context simulation (paper §2.2).

Replays only the table-lookup components — caches, TLBs, branch predictor —
over a program to produce the 14 history-context input features, WITHOUT
the O3 pipeline. This is the fast path that feeds SimNet at simulation
time (paper: ~100 MIPS class), and the hook for §5 design-space studies:
swap the branch predictor or resize a cache here, keep the trained
predictor fixed, re-simulate.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.des.branch import make_predictor
from repro_torch.des.cache import CacheHierarchy
from repro_torch.des.isa import Op
from repro_torch.des.trace import Trace
from repro_torch.des.workloads import Program


def history_features(
    prog: Program,
    caches: Optional[dict] = None,
    bpred: str = "bimodal",
):
    """Returns dict of the 14 history-context feature arrays."""
    hier = CacheHierarchy(caches)
    bp = make_predictor(bpred)
    T = prog.n
    line = hier.cfg["line"]

    mispred = np.zeros(T, bool)
    fetch_level = np.zeros(T, np.int8)
    fetch_tw = np.zeros((T, 3), np.int8)
    fetch_wb = np.zeros((T, 2), np.int8)
    data_level = np.zeros(T, np.int8)
    data_tw = np.zeros((T, 3), np.int8)
    data_wb = np.zeros((T, 3), np.int8)

    prev_line = -1
    for i in range(T):
        pc = int(prog.pc[i])
        op = int(prog.op[i])
        cur_line = pc // line
        if cur_line != prev_line:
            lvl, tw, wb = hier.fetch_access(pc)
            fetch_level[i] = lvl
            fetch_tw[i] = tw
            fetch_wb[i] = wb
            prev_line = cur_line
        else:
            fetch_level[i] = 1
        if op in (Op.LOAD, Op.STORE):
            lvl, tw, wb = hier.data_access(int(prog.addr[i]), write=(op == Op.STORE))
            data_level[i] = lvl
            data_tw[i] = tw
            data_wb[i] = wb
        if op in (Op.BRANCH, Op.JUMP_IND):
            taken = bool(prog.taken[i])
            pred = bp.predict(pc)
            wrong = (pred != taken) or (op == Op.JUMP_IND and taken and pc % 16 == 0)
            bp.update(pc, taken)
            mispred[i] = wrong

    return dict(
        mispred=mispred,
        fetch_level=fetch_level, fetch_tw=fetch_tw, fetch_wb=fetch_wb,
        data_level=data_level, data_tw=data_tw, data_wb=data_wb,
    )


def trace_with_history(prog: Program, caches=None, bpred="bimodal") -> Trace:
    """A Trace whose labels are zero — input side only (SimNet sim path)."""
    h = history_features(prog, caches, bpred)
    T = prog.n
    z = np.zeros(T, np.int64)
    return Trace(
        name=prog.name,
        pc=prog.pc, op=prog.op, src=prog.src, dst=prog.dst, addr=prog.addr,
        fetch_lat=z, exec_lat=z, store_lat=z.copy(), **h,
    )
