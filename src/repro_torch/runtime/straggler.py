"""Straggler detection + mitigation hooks (fleet-scale posture).

On a synchronous TPU mesh a slow host delays every step. The monitor keeps
an EWMA/variance of step times, flags outliers, and drives two mitigations:

  1. data-skip: the flagged host's next batch is served from the prefetch
     buffer (no host-side preprocessing on the critical path);
  2. exclusion advice: after `patience` consecutive flags, recommend an
     elastic restart without that host (runtime.elastic picks the new mesh;
     checkpoint.manager reshards the state).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.1
    threshold: float = 2.0  # flag if step_time > threshold × ewma
    patience: int = 5  # consecutive flags before exclusion advice
    window: int = 50


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.flags: Dict[int, int] = {}  # host -> consecutive flags
        self.history: deque = deque(maxlen=cfg.window)
        self.events: List[dict] = []

    def record(self, step: int, step_time: float, host_times: Optional[Dict[int, float]] = None):
        """Feed one step's timing. Returns dict of actions."""
        self.history.append(step_time)
        if self.ewma is None:
            self.ewma = step_time
        else:
            a = self.cfg.ewma_alpha
            self.ewma = (1 - a) * self.ewma + a * step_time

        actions = {"slow_step": False, "skip_hosts": [], "exclude_hosts": []}
        if step_time > self.cfg.threshold * self.ewma:
            actions["slow_step"] = True
            self.events.append({"step": step, "time": step_time, "ewma": self.ewma})
        if host_times:
            mean = sum(host_times.values()) / len(host_times)
            for h, t in host_times.items():
                if t > self.cfg.threshold * mean:
                    self.flags[h] = self.flags.get(h, 0) + 1
                    actions["skip_hosts"].append(h)
                    if self.flags[h] >= self.cfg.patience:
                        actions["exclude_hosts"].append(h)
                else:
                    self.flags[h] = 0
        return actions

    @property
    def mean_step_time(self) -> float:
        return sum(self.history) / max(len(self.history), 1)
