"""Synthetic RISC ISA for the reference DES (the repo's gem5 stand-in).

13 op classes mirror the paper's 13 operation features (Table 1): function
type, direct/indirect branch, memory barrier, etc. Register file: 64 int +
64 fp architectural registers (indices 0..127; -1 = unused slot).
"""
from __future__ import annotations

import enum

import numpy as np


class Op(enum.IntEnum):
    INT_ALU = 0
    INT_MUL = 1
    INT_DIV = 2
    FP_ALU = 3
    FP_MUL = 4
    FP_DIV = 5
    LOAD = 6
    STORE = 7
    BRANCH = 8  # direct conditional
    JUMP_IND = 9  # indirect branch/jump
    BARRIER = 10  # memory barrier
    VEC_ALU = 11
    NOP = 12


N_OP_CLASSES = 13
N_REGS = 128
MAX_SRC = 8
MAX_DST = 6

# default execution latencies per op class (cycles, excl. memory)
EXEC_LATENCY = {
    Op.INT_ALU: 1,
    Op.INT_MUL: 3,
    Op.INT_DIV: 12,
    Op.FP_ALU: 2,
    Op.FP_MUL: 4,
    Op.FP_DIV: 10,
    Op.LOAD: 1,  # + dcache latency
    Op.STORE: 1,  # address generation
    Op.BRANCH: 1,
    Op.JUMP_IND: 1,
    Op.BARRIER: 1,
    Op.VEC_ALU: 2,
    Op.NOP: 1,
}

# issue-port classes: which functional-unit pool an op needs
PORT_OF = {
    Op.INT_ALU: 0, Op.INT_MUL: 1, Op.INT_DIV: 1,
    Op.FP_ALU: 2, Op.FP_MUL: 2, Op.FP_DIV: 2,
    Op.LOAD: 3, Op.STORE: 3,
    Op.BRANCH: 0, Op.JUMP_IND: 0, Op.BARRIER: 0,
    Op.VEC_ALU: 2, Op.NOP: 0,
}
N_PORTS = 4

IS_MEM = np.zeros(N_OP_CLASSES, bool)
IS_MEM[[Op.LOAD, Op.STORE]] = True
IS_BRANCH = np.zeros(N_OP_CLASSES, bool)
IS_BRANCH[[Op.BRANCH, Op.JUMP_IND]] = True


def op_feature_row(op_class: int) -> np.ndarray:
    """13 operation features: one-hot op class (positions double as the
    direct-branch / indirect-branch / barrier indicator bits)."""
    row = np.zeros(N_OP_CLASSES, np.float32)
    row[op_class] = 1.0
    return row
