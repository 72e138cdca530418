"""SimNet feature schema — the paper's Table 1, concretely laid out.

Every instruction is a 50-float row:

  [0:13)   operation features (one-hot op class; branch/barrier bits)
  [13:21)  8 source register indices, scaled to [0,1]
  [21:27)  6 destination register indices, scaled
  [27]     branch misprediction flag            ┐
  [28]     fetch access level (/3)              │
  [29:32)  fetch table-walk levels (/2)         │ history context
  [32:34)  fetch-caused writebacks              │ (14 features, from the
  [34]     data access level (/3)               │ lightweight history
  [35:38)  data table-walk levels (/2)          │ simulation)
  [38:41)  data-caused writebacks               ┘
  [41]     residence latency (× LAT_SCALE)      ┐ dynamic — assembled by
  [42]     execution latency (× LAT_SCALE)      │ the simulator from the
  [43]     store latency (× LAT_SCALE)          │ queues at each step
  [44:49)  memory dependency flags vs current   │
  [49]     valid (1 = real context entry)       ┘

The static block [0:41) is fixed per instruction and precomputed from the
trace; the dynamic block [41:50) is written by the simulator/dataset
builder. The to-be-predicted instruction uses the same row with zeros in
the dynamic block (the paper pads 47 → 50 the same way).
"""
from __future__ import annotations

import numpy as np

from simbench.des.isa import MAX_DST, MAX_SRC, N_REGS
from simbench.des.trace import Trace

N_FEATURES = 50
STATIC_END = 41
IDX_RESID = 41
IDX_EXEC = 42
IDX_STORE = 43
IDX_DEP = 44  # 5 flags: same pc / same iline / same data addr / line / page
IDX_VALID = 49
LAT_SCALE = 1.0 / 64.0

# address-key columns for dependency-flag comparison
ADDR_PC = 0
ADDR_ILINE = 1
ADDR_DATA = 2
ADDR_DLINE = 3
ADDR_DPAGE = 4
N_ADDR_KEYS = 5

LINE_BYTES = 64
PAGE_BYTES = 4096


def static_features(trace: Trace) -> np.ndarray:
    """(T, 41) float32 static+history feature block."""
    T = trace.n
    f = np.zeros((T, STATIC_END), np.float32)
    f[np.arange(T), trace.op.astype(np.int64)] = 1.0  # [0:13) op one-hot
    f[:, 13:13 + MAX_SRC] = (trace.src.astype(np.float32) + 1.0) / N_REGS
    f[:, 21:21 + MAX_DST] = (trace.dst.astype(np.float32) + 1.0) / N_REGS
    f[:, 27] = trace.mispred.astype(np.float32)
    f[:, 28] = trace.fetch_level.astype(np.float32) / 3.0
    f[:, 29:32] = trace.fetch_tw.astype(np.float32) / 2.0
    f[:, 32:34] = trace.fetch_wb.astype(np.float32)
    f[:, 34] = trace.data_level.astype(np.float32) / 3.0
    f[:, 35:38] = trace.data_tw.astype(np.float32) / 2.0
    f[:, 38:41] = trace.data_wb.astype(np.float32)
    return f


def address_keys(trace: Trace) -> np.ndarray:
    """(T, 5) int32 comparison keys (synthetic address space fits int32).

    Zero means "no address" — dependency flags require both sides nonzero.
    """
    a = np.zeros((trace.n, N_ADDR_KEYS), np.int64)
    a[:, ADDR_PC] = trace.pc
    a[:, ADDR_ILINE] = trace.pc // LINE_BYTES
    has_data = trace.addr != 0
    a[:, ADDR_DATA] = np.where(has_data, trace.addr, 0)
    a[:, ADDR_DLINE] = np.where(has_data, trace.addr // LINE_BYTES, 0)
    a[:, ADDR_DPAGE] = np.where(has_data, trace.addr // PAGE_BYTES, 0)
    assert a.max() < 2**31, "address keys exceed int32 (re-hash required)"
    return a.astype(np.int32)


def trace_arrays(trace: Trace):
    """Everything the JAX simulator consumes, as a dict of arrays."""
    from simbench.des.isa import Op

    return dict(
        feat=static_features(trace),  # (T, 41) f32
        addr=address_keys(trace),  # (T, 5) i32
        is_store=(trace.op == int(Op.STORE)),  # (T,) bool
        labels=np.stack(
            [trace.fetch_lat, trace.exec_lat, trace.store_lat], axis=1
        ).astype(np.float32),  # (T, 3)
    )
