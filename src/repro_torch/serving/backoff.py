"""Shared exponential backoff for every polling loop in the serving tier.

One fleet means many pollers: `wait_job` clients watching a result, CLI
retry loops riding out `QueueFull` backpressure, and the router's health
prober knocking on ejected replicas. A fixed 10-20 ms sleep is fine for
one client and a hammer at fleet scale — N pollers × M jobs turns the
router into its own hot loop. Every one of those sites shares this
helper instead: start small (snappy when the wait is short), double on
each miss, cap (bounded worst-case poll rate), reset on progress.

    b = Backoff(initial_s=0.005, cap_s=0.25)
    while not done():
        b.sleep()          # 5 ms, 10, 20, ... capped at 250 ms
    b.reset()              # progress: the next wait starts snappy again
"""
from __future__ import annotations

import time


class Backoff:
    """Capped exponential delay sequence: ``initial * factor**k`` up to
    ``cap``. Not thread-safe — one instance per polling loop."""

    def __init__(self, initial_s: float = 0.005, cap_s: float = 0.25,
                 factor: float = 2.0):
        if initial_s <= 0 or cap_s < initial_s or factor < 1.0:
            raise ValueError(
                f"need 0 < initial_s <= cap_s and factor >= 1, got "
                f"initial_s={initial_s}, cap_s={cap_s}, factor={factor}"
            )
        self.initial_s = float(initial_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self._current = self.initial_s

    def peek(self) -> float:
        """The delay the next ``next()``/``sleep()`` will use."""
        return self._current

    def next(self) -> float:
        """Return the current delay and advance the sequence."""
        d = self._current
        self._current = min(self._current * self.factor, self.cap_s)
        return d

    def sleep(self) -> float:
        """``time.sleep`` the current delay, advance, return the delay
        actually slept."""
        d = self.next()
        time.sleep(d)
        return d

    def reset(self) -> None:
        """Back to ``initial_s`` — call on progress so the next wait in
        the same loop starts snappy."""
        self._current = self.initial_s

    def __repr__(self):
        return (f"Backoff({self.initial_s!r}, cap_s={self.cap_s!r}, "
                f"factor={self.factor!r}, current={self._current!r})")
