"""Typed results for the SimNet public API (frozen dataclasses).

Every simulation / training entry point returns one of these instead of an
ad-hoc dict: the fields are the contract, `.to_dict()` is the JSON form
the CLI emits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkloadResult:
    """One workload's totals out of a packed simulation."""

    name: str
    total_cycles: float
    cpi: float
    n_instructions: int
    n_lanes: int
    overflow: int
    # DES comparison — present only when the input Trace carried labels
    des_cycles: Optional[float] = None
    des_cpi: Optional[float] = None
    cpi_error: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "total_cycles": self.total_cycles,
            "cpi": self.cpi,
            "n_instructions": self.n_instructions,
            "n_lanes": self.n_lanes,
            "overflow": self.overflow,
        }
        if self.des_cycles is not None:
            d["des_cycles"] = self.des_cycles
            d["des_cpi"] = self.des_cpi
            d["cpi_error"] = self.cpi_error
        return d


@dataclasses.dataclass(frozen=True)
class SimResult:
    """A packed simulation run: per-workload totals + whole-run timing.

    The single-workload case is just ``len(result) == 1`` — there is one
    simulation path, not two result shapes.
    """

    workloads: Tuple[WorkloadResult, ...]
    total_cycles: float
    total_instructions: int
    throughput_ips: float
    seconds: float
    first_call_seconds: float
    # compile-cache activity of this run (hits/misses/compile_seconds),
    # None when the producer did not record it
    cache: Optional[Mapping[str, float]] = None

    @property
    def n_workloads(self) -> int:
        return len(self.workloads)

    @property
    def cpi(self) -> float:
        return self.total_cycles / max(self.total_instructions, 1)

    def __len__(self) -> int:
        return len(self.workloads)

    def __iter__(self) -> Iterator[WorkloadResult]:
        return iter(self.workloads)

    def __getitem__(self, i: int) -> WorkloadResult:
        return self.workloads[i]

    def workload(self, name: str) -> WorkloadResult:
        for w in self.workloads:
            if w.name == name:
                return w
        raise KeyError(name)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready form (the CLI's output shape)."""
        d = {
            "workloads": [w.to_dict() for w in self.workloads],
            "total_cycles": self.total_cycles,
            "total_instructions": self.total_instructions,
            "n_workloads": self.n_workloads,
            "throughput_ips": self.throughput_ips,
            "seconds": self.seconds,
            "first_call_seconds": self.first_call_seconds,
        }
        if self.cache is not None:
            d["cache"] = dict(self.cache)
        return d


@dataclasses.dataclass(frozen=True)
class TrainResult:
    """Outcome of one predictor training run (metadata only is JSON-able;
    the params live on the session / PredictorArtifact)."""

    kind: str
    output: str
    ctx_len: int
    epochs: int
    n_train: int
    train_loss: Tuple[float, ...]
    val_loss: Tuple[float, ...]
    seconds: float
    pred_errors: Optional[Mapping[str, float]] = None

    @property
    def final_val_loss(self) -> float:
        return self.val_loss[-1] if self.val_loss else float("nan")

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "kind": self.kind,
            "output": self.output,
            "ctx_len": self.ctx_len,
            "epochs": self.epochs,
            "n_train": self.n_train,
            "train_loss": list(self.train_loss),
            "val_loss": list(self.val_loss),
            "seconds": self.seconds,
        }
        if self.pred_errors is not None:
            d["pred_errors"] = dict(self.pred_errors)
        return d


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """A design-space sweep: every point rode ONE packed simulation.

    ``labels`` assigns each workload of ``result`` to its design point (one
    point may contribute several benchmarks). ``relative()`` is the paper's
    Table 5 readout: per-benchmark speedup of each point vs the baseline
    (first) point, from the SimNet CPIs — and from the DES labels when the
    input traces carried them.
    """

    labels: Tuple[str, ...]
    result: SimResult

    def __post_init__(self):
        if len(self.labels) != len(self.result.workloads):
            raise ValueError(
                f"{len(self.labels)} labels for {len(self.result.workloads)} workloads"
            )

    @property
    def points(self) -> Tuple[str, ...]:
        seen: list = []
        for l in self.labels:
            if l not in seen:
                seen.append(l)
        return tuple(seen)

    def point(self, label: str) -> Tuple[WorkloadResult, ...]:
        return tuple(
            w for l, w in zip(self.labels, self.result.workloads) if l == label
        )

    def relative(self, baseline: Optional[str] = None) -> Dict[str, Dict[str, Dict[str, float]]]:
        """point → benchmark → {"simnet": speedup, "des": speedup?} vs baseline.
        Benchmarks a point does not share with the baseline are skipped."""
        base = baseline if baseline is not None else self.points[0]
        ref = {w.name: w for w in self.point(base)}
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for label in self.points:
            if label == base:
                continue
            row: Dict[str, Dict[str, float]] = {}
            for w in self.point(label):
                r = ref.get(w.name)
                if r is None:
                    continue
                cell = {"simnet": r.total_cycles / w.total_cycles}
                if w.des_cycles is not None and r.des_cycles is not None:
                    cell["des"] = r.des_cycles / w.des_cycles
                row[w.name] = cell
            out[label] = row
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "labels": list(self.labels),
            "points": {
                label: [w.to_dict() for w in self.point(label)]
                for label in self.points
            },
            "relative": self.relative() if len(self.points) > 1 else {},
            "result": self.result.to_dict(),
        }
