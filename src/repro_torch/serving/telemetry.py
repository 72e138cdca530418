"""Serving observability: histograms, circuit breakers, structured logs.

The paper's throughput story only survives deployment if the service can
be *run hot* — NeuroScalar's "simulation in the wild" needs the operator
to see tail latency, queue pressure and pack density, and to contain a
bad artifact before it eats the drain loop. This module is that layer,
stdlib-only:

- `Histogram` — fixed-bucket counters with *lock-free reads*: writers
  serialize on a tiny per-histogram mutex (exact counts under threaded
  load), readers take a seqlock-style consistent snapshot without ever
  blocking a writer or touching the service lock. Percentiles use
  inverted-CDF rank walking with linear interpolation inside the bucket,
  so `percentile(q)` always lands in the bucket holding the true q-th
  sample (error bounded by bucket resolution).
- `CircuitBreaker` — closed → open after N consecutive failures, a
  single half-open probe after the cooldown, closed again on probe
  success. The registry keeps one per resident model: a repeatedly
  failing artifact is rejected at ``submit`` (fast-fail) instead of
  detonating batch after batch inside the scheduler thread.
- structured logs — one JSON object per event on the ``repro.serving``
  logger, every job tagged with a correlation id minted at submit, so a
  request can be followed submit → dispatch → completion across threads.

`Telemetry` bundles the service's standard histograms (queue wait,
end-to-end latency, queue depth at admission, jobs per batch); the whole
snapshot rides ``SimServe.stats()`` and the HTTP ``/v1/stats`` endpoint.
"""
from __future__ import annotations

import bisect
import json
import logging
import math
import threading
import time
import uuid
from typing import Any, Dict, Optional, Sequence

LOG = logging.getLogger("repro.serving")

# bucket upper edges; the implicit last bucket is overflow (> bounds[-1])
LATENCY_BOUNDS_MS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)
DEPTH_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)
BATCH_JOBS_BOUNDS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0)


def new_correlation_id() -> str:
    """A short random id that follows one job through every log record."""
    return uuid.uuid4().hex[:12]


def log_event(event: str, *, level: int = logging.DEBUG, **fields) -> None:
    """Emit one structured (JSON-object) log record on ``repro.serving``.

    Per-job traffic logs at DEBUG (high volume); admission refusals,
    deadline expiries and breaker transitions log at WARNING/ERROR so a
    default-configured logger surfaces only the operational signal."""
    if LOG.isEnabledFor(level):
        LOG.log(level, json.dumps({"event": event, **fields},
                                  default=str, sort_keys=True))


class Histogram:
    """Fixed-bucket histogram: exact counts, lock-free consistent reads.

    ``bounds`` are ascending inclusive upper edges; values above the last
    edge land in an implicit overflow bucket. Writers increment under a
    mutex (so concurrent ``observe`` calls never lose counts); readers
    use a seqlock — copy the counters, then verify the version stamp was
    even and unchanged — so ``snapshot()`` never blocks the dispatch
    path and still never observes a half-applied write."""

    def __init__(self, bounds: Sequence[float]):
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"bounds must be ascending and distinct: {bounds}")
        self.bounds = b
        self._counts = [0] * (len(b) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._version = 0  # odd while a write is in flight
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._version += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._version += 1

    def _read(self):
        """Seqlock read: retry until a copy straddles no write."""
        while True:
            v1 = self._version
            if v1 & 1:
                time.sleep(0)  # a write is mid-flight; yield and retry
                continue
            counts = list(self._counts)
            state = (counts, self._count, self._sum, self._min, self._max)
            if self._version == v1:
                return state
            time.sleep(0)

    def _percentile(self, q: float, counts, count, mn, mx) -> Optional[float]:
        if count == 0:
            return None
        if q <= 0:
            return mn
        # inverted CDF: the rank-k smallest sample, k = ceil(q/100 * n)
        rank = min(max(int(math.ceil(q / 100.0 * count)), 1), count)
        cum = 0
        for i, c in enumerate(counts):
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(mn, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else mx
                hi = max(hi, lo)
                # interpolate within the bucket; the result stays inside
                # the bucket that holds the true rank-k sample
                return lo + (hi - lo) * (rank - cum) / c
            cum += c
        return mx  # unreachable with consistent counts

    def percentile(self, q: float) -> Optional[float]:
        counts, count, _, mn, mx = self._read()
        return self._percentile(q, counts, count, mn, mx)

    @property
    def count(self) -> int:
        return self._read()[1]

    def snapshot(self) -> Dict[str, Any]:
        counts, count, total, mn, mx = self._read()
        pct = {f"p{q}": self._percentile(q, counts, count, mn, mx)
               for q in (50, 90, 99)}
        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else None,
            "min": mn if count else None,
            "max": mx if count else None,
            "bounds": list(self.bounds),
            "counts": counts,
            **pct,
        }


def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge `Histogram.snapshot()` dicts from several services into one
    fleet-wide snapshot (same shape, percentiles recomputed).

    Fixed-bucket histograms merge exactly: per-bucket counts add, and the
    inverted-CDF percentile walk over the summed counts lands in the same
    bucket it would over the union of the raw samples — the property the
    router's aggregated ``/v1/stats`` relies on. All snapshots must share
    identical bounds (the serving tier's are module constants)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return Histogram((1.0,)).snapshot()
    bounds = tuple(snaps[0]["bounds"])
    if any(tuple(s["bounds"]) != bounds for s in snaps):
        raise ValueError("cannot merge histograms with differing bounds")
    merged = Histogram(bounds)
    merged._counts = [sum(s["counts"][i] for s in snaps)
                      for i in range(len(bounds) + 1)]
    merged._count = sum(s["count"] for s in snaps)
    merged._sum = sum(s["sum"] for s in snaps)
    nonempty = [s for s in snaps if s["count"]]
    if nonempty:
        merged._min = min(s["min"] for s in nonempty)
        merged._max = max(s["max"] for s in nonempty)
    return merged.snapshot()


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class BreakerOpen(RuntimeError):
    """The circuit breaker refused the call (model is isolated)."""


class CircuitBreaker:
    """Per-model failure isolation: closed → open → half-open → closed.

    ``failure_threshold`` *consecutive* failures open the breaker; while
    open, ``allow()`` fast-fails. After ``reset_after_s`` the next
    ``allow()`` admits exactly one half-open probe; the probe's success
    closes the breaker, its failure re-opens it. A probe that never
    reports back (crashed client) goes stale after another
    ``reset_after_s`` and a new probe is admitted — the breaker cannot
    wedge itself shut."""

    def __init__(self, name: str = "", *, failure_threshold: int = 5,
                 reset_after_s: float = 30.0, clock=time.monotonic):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_at: Optional[float] = None  # half-open probe in flight
        self._total_failures = 0
        self._times_opened = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call against this model proceed? Consumes the half-open
        probe slot when it grants one."""
        now = self._clock()
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self.reset_after_s:
                    return False
                self._state = HALF_OPEN
                self._probe_at = now
                log_event("breaker.half_open", level=logging.WARNING,
                          model=self.name)
                return True
            # HALF_OPEN: one probe at a time, but a stale probe (its
            # submitter died before reporting) must not wedge the breaker
            if self._probe_at is not None and now - self._probe_at < self.reset_after_s:
                return False
            self._probe_at = now
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state != CLOSED:
                log_event("breaker.closed", level=logging.WARNING,
                          model=self.name)
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_at = None

    def record_failure(self) -> None:
        now = self._clock()
        with self._lock:
            self._consecutive_failures += 1
            self._total_failures += 1
            self._probe_at = None
            if (self._state == HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                if self._state != OPEN:
                    self._times_opened += 1
                    log_event("breaker.open", level=logging.WARNING,
                              model=self.name,
                              consecutive_failures=self._consecutive_failures)
                self._state = OPEN
                self._opened_at = now

    def trip(self, reason: str = "") -> None:
        """Force-open immediately, bypassing the failure count — for faults
        that cannot heal on retry (a checksum-failed artifact)."""
        now = self._clock()
        with self._lock:
            if self._state != OPEN:
                self._times_opened += 1
                log_event("breaker.tripped", level=logging.ERROR,
                          model=self.name, reason=reason)
            self._state = OPEN
            self._opened_at = now
            self._consecutive_failures = max(
                self._consecutive_failures, self.failure_threshold
            )
            self._total_failures += 1
            self._probe_at = None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "total_failures": self._total_failures,
                "times_opened": self._times_opened,
                "failure_threshold": self.failure_threshold,
                "reset_after_s": self.reset_after_s,
            }


class Telemetry:
    """The service's standard histogram set (one instance per SimServe).

    - ``queue_wait_ms``  — submit → dispatch (scheduling latency)
    - ``service_ms``     — submit → result pinned (end-to-end latency)
    - ``queue_depth``    — pending jobs observed at each admission
    - ``batch_jobs``     — jobs per dispatched batch (pack occupancy)
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.queue_wait_ms = Histogram(LATENCY_BOUNDS_MS)
        self.service_ms = Histogram(LATENCY_BOUNDS_MS)
        self.queue_depth = Histogram(DEPTH_BOUNDS)
        self.batch_jobs = Histogram(BATCH_JOBS_BOUNDS)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "queue_wait_ms": self.queue_wait_ms.snapshot(),
            "service_ms": self.service_ms.snapshot(),
            "queue_depth": self.queue_depth.snapshot(),
            "batch_jobs": self.batch_jobs.snapshot(),
        }
