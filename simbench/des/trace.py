"""Instruction trace record: program + history-context features + labels."""
from __future__ import annotations

import dataclasses

import numpy as np

from simbench.des.workloads import Program


@dataclasses.dataclass
class Trace:
    """Everything SimNet needs: static properties, history-context features
    (from lightweight simulation), and the DES ground-truth latencies."""

    name: str
    # static
    pc: np.ndarray  # (T,)
    op: np.ndarray  # (T,)
    src: np.ndarray  # (T, 8)
    dst: np.ndarray  # (T, 6)
    addr: np.ndarray  # (T,)
    # history-context features (paper Table 1, bottom row: 14 features)
    mispred: np.ndarray  # (T,) bool
    fetch_level: np.ndarray  # (T,)
    fetch_tw: np.ndarray  # (T, 3)
    fetch_wb: np.ndarray  # (T, 2)
    data_level: np.ndarray  # (T,)
    data_tw: np.ndarray  # (T, 3)
    data_wb: np.ndarray  # (T, 3)
    # labels
    fetch_lat: np.ndarray  # (T,)
    exec_lat: np.ndarray  # (T,)
    store_lat: np.ndarray  # (T,) 0 for non-stores

    @property
    def n(self):
        return len(self.pc)

    @property
    def total_cycles(self) -> int:
        """Program time by Eq. 1: Σ fetch + drain of the last instructions."""
        total = int(self.fetch_lat.sum())
        t = np.cumsum(self.fetch_lat)
        drain = np.maximum(self.exec_lat, self.store_lat) + t - t[-1]
        return total + int(drain.max())

    @property
    def cpi(self) -> float:
        return self.total_cycles / max(self.n, 1)

    def save(self, path):
        np.savez_compressed(path, name=self.name, **{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "name"
        })

    @staticmethod
    def load(path) -> "Trace":
        z = np.load(path, allow_pickle=False)
        kw = {k: z[k] for k in z.files if k != "name"}
        return Trace(name=str(z["name"]), **kw)

    def slice(self, lo, hi) -> "Trace":
        kw = {
            f.name: getattr(self, f.name)[lo:hi]
            for f in dataclasses.fields(self)
            if f.name != "name"
        }
        return Trace(name=f"{self.name}[{lo}:{hi}]", **kw)
