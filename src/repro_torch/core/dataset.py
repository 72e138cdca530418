"""Teacher-forced sample generation (paper §2.4 "Data Acquisition") — the
port of ``repro.core.dataset``.

The dataset builder runs the *same* context-queue machinery as the
simulator, but with ground-truth latencies (teacher forcing), so the
training inputs are distributed as what the predictor sees when it
replaces the labels at simulation time. Here that machinery is the port's
own simulator (`core.simulator.make_sim_scan` with no predictor, stepped
by `run_steps`) on ``device``, the card unless the caller asks for the
CPU. Samples are deduplicated (repeated scenarios are common, paper §2.4)
and split 90/5/5 with the reference's seed, so both packages give the same
arrays bit for bit.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import features as F
from repro_torch.core.simulator import SimConfig, init_state, make_sim_scan, run_steps
from repro_torch.des.trace import Trace


def teacher_forced_samples(
    trace: Trace,
    cfg: SimConfig,
    n_lanes: int = 8,
    chunk: int = 2048,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (M, 1+Q, 50) float16, Y (M, 3) float32)."""
    dev = resolve_device(device)
    arrs = F.trace_arrays(trace)
    T = arrs["feat"].shape[0]
    per = (T // n_lanes) // chunk * chunk
    if per == 0:
        per = T // n_lanes
        chunk = per
    T_used = per * n_lanes

    def lanes_first(a):
        return np.swapaxes(a[:T_used].reshape(n_lanes, per, *a.shape[1:]), 0, 1)

    xs_np = {k: lanes_first(v) for k, v in arrs.items()}
    step = make_sim_scan(None, cfg)
    state = init_state(n_lanes, cfg, dev)
    X_parts, Y_parts = [], []
    for lo in range(0, per, chunk):
        xs = {k: torch.from_numpy(np.ascontiguousarray(v[lo : lo + chunk])).to(dev)
              for k, v in xs_np.items()}
        state, outs = run_steps(step, state, xs)
        # f32 -> f16 rounds to nearest even on either device, as numpy does
        x = outs["x"].to(torch.float16).cpu().numpy()  # (chunk, L, N, 50)
        y = xs_np["labels"][lo : lo + chunk]
        X_parts.append(x.reshape(-1, x.shape[2], x.shape[3]))
        Y_parts.append(y.reshape(-1, 3).astype(np.float32))
    return np.concatenate(X_parts), np.concatenate(Y_parts)


def dedup(X: np.ndarray, Y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop duplicate (x, y) samples via CRC32 of the raw bytes."""
    M = X.shape[0]
    hashes = np.empty(M, np.uint64)
    for i in range(M):
        h = zlib.crc32(X[i].tobytes())
        h = (h << 32) | zlib.crc32(Y[i].tobytes(), h)
        hashes[i] = np.uint64(h & 0xFFFFFFFFFFFFFFFF)
    _, idx = np.unique(hashes, return_index=True)
    idx.sort()
    return X[idx], Y[idx]


def build_dataset(
    traces: List[Trace],
    cfg: SimConfig,
    n_lanes: int = 8,
    seed: int = 0,
    do_dedup: bool = True,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    Xs, Ys = [], []
    for tr in traces:
        X, Y = teacher_forced_samples(tr, cfg, n_lanes=n_lanes, device=device)
        Xs.append(X)
        Ys.append(Y)
    X = np.concatenate(Xs)
    Y = np.concatenate(Ys)
    if do_dedup:
        X, Y = dedup(X, Y)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    X, Y = X[perm], Y[perm]
    n = len(X)
    n_val = max(n // 20, 1)
    return {
        "train_x": X[: n - 2 * n_val], "train_y": Y[: n - 2 * n_val],
        "val_x": X[n - 2 * n_val : n - n_val], "val_y": Y[n - 2 * n_val : n - n_val],
        "test_x": X[n - n_val :], "test_y": Y[n - n_val :],
    }


# ---------------------------------------------------------------------------
# Ithemal-style baseline inputs: fixed window of previous instructions
# ---------------------------------------------------------------------------

def ithemal_samples(trace: Trace, window: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-window inputs (paper's enhanced-Ithemal comparison): the last
    ``window`` program-order predecessors regardless of retirement. Same
    50-feature rows; residence = Σ fetch latencies since that instruction.
    """
    arrs = F.trace_arrays(trace)
    T = arrs["feat"].shape[0]
    stat = arrs["feat"]  # (T, 41)
    addr = arrs["addr"]
    labels = arrs["labels"]
    fetch_cum = np.cumsum(labels[:, 0])

    N = window + 1
    X = np.zeros((T, N, F.N_FEATURES), np.float16)
    # current instruction rows
    X[:, 0, : F.STATIC_END] = stat
    X[:, 0, F.IDX_VALID] = 1.0
    for w in range(1, N):
        rows = np.arange(w, T)
        prev = rows - w
        X[rows, w, : F.STATIC_END] = stat[prev]
        X[rows, w, F.IDX_RESID] = (fetch_cum[rows] - fetch_cum[prev]) * F.LAT_SCALE
        X[rows, w, F.IDX_EXEC] = labels[prev, 1] * F.LAT_SCALE
        X[rows, w, F.IDX_STORE] = labels[prev, 2] * F.LAT_SCALE
        dep = np.logical_and(addr[rows] == addr[prev], addr[rows] != 0)
        X[rows, w, F.IDX_DEP : F.IDX_DEP + 5] = dep.astype(np.float16)
        X[rows, w, F.IDX_VALID] = 1.0
    return X, labels.astype(np.float32)
