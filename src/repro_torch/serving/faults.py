"""Deterministic, seeded fault injection for the serving stack.

from __future__ import annotations
The chaos plane is a process-wide :class:`FaultPlan`: a seed plus a map of
*fault sites* to :class:`FaultSpec` triggers.  Production code calls
:func:`fire` at named seams; with no plan installed the call is a counter-free
no-op, with a plan installed the site's spec decides — deterministically, from
the seed and the site's arrival counter alone — whether that arrival fails,
stalls, or hands back a corrupted payload.  Because every decision is a pure
function of ``(seed, site, arrival index)``, a chaos drill replays bit-for-bit
from its seed: same plan, same call order, same faults.

Known sites (each threaded through an existing seam):

==================  ===========================================================
``artifact.load``   checkpoint payload bytes read off disk (corrupt flips a
                    byte *before* checksum verification)
``compile``         executable build inside ``CompileCache.get`` (cache hits
                    never count — the site meters real compiles)
``batch.execute``   engine dispatch in the drain loop (``delay_ms`` simulates
                    a hung batch for the watchdog)
``batch.numeric``   per-workload cycle totals (corrupt poisons them with NaN
                    to flush the numeric guard)
``http.request``    client-side transport, fired *before* the request is sent
                    so a retry can never duplicate work
``replica.crash``   fleet supervisor tick (a failure decision SIGKILLs a
                    deterministically chosen replica)
==================  ===========================================================

Spec strings (CLI ``--faults`` / env ``REPRO_FAULTS``) look like::

    seed=7;compile=fail_once:1;batch.execute=delay_ms:500,delay_once:1

i.e. ``;``-separated ``site=trigger:value,...`` clauses plus an optional
``seed=N`` clause.  :meth:`FaultPlan.to_spec` round-trips, which is how the
fleet hands a plan to replica subprocesses.
"""


import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "FAULT_SITES",
    "FaultInjected",
    "FaultSpec",
    "FaultPlan",
    "install",
    "install_from_env",
    "clear",
    "active",
    "fire",
    "snapshot",
]

# Canonical site names; fire() accepts others (forward-compat) but the spec
# parser rejects typos against this set so drills fail fast on a bad plan.
FAULT_SITES = (
    "artifact.load",
    "compile",
    "batch.execute",
    "batch.numeric",
    "http.request",
    "replica.crash",
)


class FaultInjected(RuntimeError):
    """An injected failure (never raised unless a plan arms the site)."""

    def __init__(self, site: str, arrival: int):
        super().__init__(f"injected fault at site {site!r} (arrival {arrival})")
        self.site = site
        self.arrival = arrival


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Triggers for one site.  All counts are arrivals at that site.

    after      first N arrivals are exempt from every trigger (lets a drill
               crash a replica mid-run instead of at tick 1)
    fail_once  the next N eligible arrivals raise FaultInjected
    fail_rate  thereafter, each arrival fails with this probability (seeded)
    delay_ms   eligible arrivals that do not fail sleep this long
    delay_once limit delay_ms to the first N eligible arrivals (0 = every one)
    corrupt    the next N eligible arrivals get a corrupted payload
    """

    after: int = 0
    fail_once: int = 0
    fail_rate: float = 0.0
    delay_ms: float = 0.0
    delay_once: int = 0
    corrupt: int = 0

    def validate(self, site: str) -> None:
        if self.after < 0 or self.fail_once < 0 or self.delay_once < 0 or self.corrupt < 0:
            raise ValueError(f"fault site {site!r}: counts must be >= 0")
        if not 0.0 <= self.fail_rate <= 1.0:
            raise ValueError(f"fault site {site!r}: fail_rate must be in [0, 1]")
        if self.delay_ms < 0:
            raise ValueError(f"fault site {site!r}: delay_ms must be >= 0")


def _corrupt_payload(payload: Any, rng: random.Random) -> Any:
    """Deterministically tamper a payload: flip a byte, or NaN-poison floats."""
    if isinstance(payload, (bytes, bytearray)):
        if len(payload) == 0:
            return payload
        buf = bytearray(payload)
        pos = rng.randrange(len(buf))
        buf[pos] ^= 0xFF
        return bytes(buf)
    if isinstance(payload, np.ndarray) and payload.size:
        out = np.array(payload, copy=True)
        if np.issubdtype(out.dtype, np.floating):
            flat = out.reshape(-1)
            flat[rng.randrange(flat.size)] = np.nan
        else:
            flat = out.reshape(-1)
            flat[rng.randrange(flat.size)] ^= np.asarray(-1, dtype=out.dtype)
        return out
    # Unknown payloads pass through untouched; the trigger still counts.
    return payload


class FaultPlan:
    """Seeded site→spec schedule.  Thread-safe; decisions depend only on the
    seed and each site's arrival counter, never on wall clock."""

    def __init__(self, seed: int = 0, sites: Optional[Mapping[str, Any]] = None):
        self.seed = int(seed)
        self.sites: Dict[str, FaultSpec] = {}
        for name, spec in dict(sites or {}).items():
            if name not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {name!r} (known: {', '.join(FAULT_SITES)})"
                )
            if isinstance(spec, Mapping):
                spec = FaultSpec(**spec)
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"fault site {name!r}: expected FaultSpec or mapping")
            spec.validate(name)
            self.sites[str(name)] = spec
        self._lock = threading.Lock()
        self._arrivals: Dict[str, int] = {}
        self._fails: Dict[str, int] = {}
        self._delays: Dict[str, int] = {}
        self._corruptions: Dict[str, int] = {}
        # Per-site independent RNG streams so one site's draw count never
        # perturbs another site's schedule.
        self._rngs: Dict[str, random.Random] = {
            name: random.Random(f"{self.seed}:{name}") for name in self.sites
        }
        # Bounded decision log for determinism tests: (site, arrival, action).
        self._log: List[Tuple[str, int, str]] = []
        self._log_cap = 4096

    # -- construction from strings -------------------------------------------

    @classmethod
    def from_spec(cls, text: str) -> "FaultPlan":
        """Parse ``seed=7;site=trigger:value,trigger:value;...``."""
        seed = 0
        sites: Dict[str, Dict[str, float]] = {}
        field_names = {f.name for f in dataclasses.fields(FaultSpec)}
        int_fields = {"after", "fail_once", "delay_once", "corrupt"}
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if "=" not in clause:
                raise ValueError(f"bad fault clause {clause!r} (expected key=value)")
            key, _, val = clause.partition("=")
            key = key.strip()
            if key == "seed":
                seed = int(val)
                continue
            if key not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {key!r} (known: {', '.join(FAULT_SITES)})"
                )
            spec = sites.setdefault(key, {})
            for trig in val.split(","):
                trig = trig.strip()
                if not trig:
                    continue
                tname, sep, tval = trig.partition(":")
                tname = tname.strip()
                if tname not in field_names:
                    raise ValueError(
                        f"fault site {key!r}: unknown trigger {tname!r} "
                        f"(known: {', '.join(sorted(field_names))})"
                    )
                if not sep:
                    # bare trigger shorthand: fail_once / corrupt imply 1
                    tval = "1"
                spec[tname] = int(tval) if tname in int_fields else float(tval)
        return cls(seed=seed, sites=sites)

    def to_spec(self) -> str:
        """Inverse of :meth:`from_spec` (used to hand plans to replicas)."""
        parts = [f"seed={self.seed}"]
        defaults = FaultSpec()
        for name in sorted(self.sites):
            spec = self.sites[name]
            trigs = []
            for f in dataclasses.fields(FaultSpec):
                v = getattr(spec, f.name)
                if v != getattr(defaults, f.name):
                    if isinstance(v, float) and v == int(v):
                        v = int(v) if f.name != "fail_rate" else v
                    trigs.append(f"{f.name}:{v}")
            parts.append(f"{name}={','.join(trigs)}")
        return ";".join(parts)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> Optional["FaultPlan"]:
        import os

        text = (env if env is not None else os.environ).get("REPRO_FAULTS", "").strip()
        return cls.from_spec(text) if text else None

    # -- firing ---------------------------------------------------------------

    def _note(self, site: str, arrival: int, action: str) -> None:
        if len(self._log) < self._log_cap:
            self._log.append((site, arrival, action))

    def fire(
        self,
        site: str,
        payload: Any = None,
        *,
        sleep: Callable[[float], None] = time.sleep,
    ) -> Any:
        """One arrival at ``site``.  May raise :class:`FaultInjected`, sleep,
        or return a corrupted copy of ``payload``; otherwise returns it as-is.
        """
        spec = self.sites.get(site)
        if spec is None:
            return payload
        with self._lock:
            arrival = self._arrivals.get(site, 0) + 1
            self._arrivals[site] = arrival
            if arrival <= spec.after:
                self._note(site, arrival, "pass")
                return payload
            eligible = arrival - spec.after
            fail = False
            if eligible <= spec.fail_once:
                fail = True
            elif spec.fail_rate > 0.0:
                rng = self._rngs.setdefault(site, random.Random(f"{self.seed}:{site}"))
                fail = rng.random() < spec.fail_rate
            if fail:
                self._fails[site] = self._fails.get(site, 0) + 1
                self._note(site, arrival, "fail")
                raise FaultInjected(site, arrival)
            delay = 0.0
            if spec.delay_ms > 0.0 and (spec.delay_once == 0 or eligible <= spec.delay_once):
                delay = spec.delay_ms / 1000.0
                self._delays[site] = self._delays.get(site, 0) + 1
            corrupted = False
            if eligible <= spec.corrupt:
                rng = self._rngs.setdefault(site, random.Random(f"{self.seed}:{site}"))
                payload = _corrupt_payload(payload, rng)
                corrupted = True
                self._corruptions[site] = self._corruptions.get(site, 0) + 1
            self._note(
                site,
                arrival,
                "corrupt" if corrupted else ("delay" if delay else "pass"),
            )
        if delay:
            sleep(delay)
        return payload

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "sites": {
                    name: {
                        "arrivals": self._arrivals.get(name, 0),
                        "fails": self._fails.get(name, 0),
                        "delays": self._delays.get(name, 0),
                        "corruptions": self._corruptions.get(name, 0),
                    }
                    for name in self.sites
                },
            }

    def decision_log(self) -> Tuple[Tuple[str, int, str], ...]:
        with self._lock:
            return tuple(self._log)


# -- process-wide active plan --------------------------------------------------

_active_lock = threading.Lock()
_active: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    global _active
    with _active_lock:
        _active = plan


def install_from_env(env: Optional[Mapping[str, str]] = None) -> Optional[FaultPlan]:
    """Install a plan from ``REPRO_FAULTS`` if set; returns it (or None)."""
    plan = FaultPlan.from_env(env)
    if plan is not None:
        install(plan)
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _active


def fire(site: str, payload: Any = None, *, sleep: Callable[[float], None] = time.sleep) -> Any:
    """Arrival at a fault site.  No-op passthrough when no plan is installed."""
    plan = _active
    if plan is None:
        return payload
    return plan.fire(site, payload, sleep=sleep)


def snapshot() -> Optional[Dict[str, Any]]:
    plan = _active
    return plan.snapshot() if plan is not None else None
