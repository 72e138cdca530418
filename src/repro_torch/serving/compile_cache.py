"""Cache of the SimNet engine's resident chunk programs — the port of
``repro.serving.compile_cache``.

The reference keys AOT-compiled XLA executables; the port keys the same
thing in PyTorch terms. On the card a program is one CUDA graph of a whole
chunk (`serving.simnet_engine.ChunkGraph`): capturing and instantiating it
is the port's "compile", and a replay runs the chunk's kernels without
Python. On the CPU a program is the eager chunk function under the same
key and the same counters.

1. **Weights are not part of the key.** Programs are keyed by
   `ExecutableKey` — (PredictorConfig, SimConfig, lane bucket, chunk,
   mesh, kernel flag) — never by the weights: a graph reads its weights
   from parameter slots of its own, which the engine refills when the
   entry was last run with other weights. Every model of the same
   kind/ctx reuses one program; teacher-forced runs key on
   ``predictor=None``.
2. **Bucketing.** Lane counts round up to power-of-two buckets (dead
   lanes ride along fully masked, so totals are bit-identical — see
   `pad_packed_lanes`), and the streaming chunk rounds to a power of two
   capped at the configured maximum.

A program is bound to one device, so there is one cache per device
(`global_cache(device)`) rather than a device field in the key.

Builds run OUTSIDE the cache's lock, coordinated by per-key in-flight
futures: two shapes build in parallel, hit-path lookups never block
behind a build, and two callers of the same shape still build it exactly
once — the second waits on the first's future. A ``builder()`` that
raises is never counted as a build and never poisons the key: its
waiters see the error, and the next ``get`` retries the build.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.simulator import SimConfig


def lane_bucket(n_lanes: int) -> int:
    """Round a lane count up to the next power of two (min 1)."""
    if n_lanes < 1:
        raise ValueError(f"need at least one lane, got {n_lanes}")
    return 1 << (n_lanes - 1).bit_length()


def chunk_bucket(n_steps: int, max_chunk: int) -> int:
    """Streaming chunk for a pack of ``n_steps``: the next power of two,
    capped at ``max_chunk``. Short packs pay a little padding (inactive
    masked steps) in exchange for program reuse across trace lengths."""
    if n_steps < 1 or max_chunk < 1:
        raise ValueError(f"need positive steps/chunk, got {n_steps}/{max_chunk}")
    return min(1 << (n_steps - 1).bit_length(), max_chunk)


@dataclasses.dataclass(frozen=True)
class ExecutableKey:
    """Everything a chunk program depends on.

    Weights are deliberately absent: a program takes them as an argument,
    so any model with the same architecture hits the same entry.
    ``predictor`` is None for teacher-forced replay. ``mesh`` is always
    None in the port (one device per program).
    """

    predictor: Optional[PredictorConfig]
    sim_cfg: SimConfig
    n_lanes: int  # bucketed lane count
    chunk: int  # bucketed streaming chunk
    mesh: Optional[Tuple] = None
    use_kernel: bool = False

    def describe(self) -> str:
        """The reference's name of the key, plus "/kernel" for a kernel
        program, so that ``stats()`` keeps a shape's kernel and plain
        programs apart (the reference's names merge them)."""
        kind = self.predictor.kind if self.predictor is not None else "teacher-forced"
        return (f"{kind}/ctx{self.sim_cfg.ctx_len}/{self.sim_cfg.layout}"
                f"/L{self.n_lanes}/T{self.chunk}" + ("/kernel" if self.use_kernel else ""))


class CompileCache:
    """Thread-safe map ExecutableKey → resident chunk program.

    ``get(key, builder)`` returns the cached program or invokes
    ``builder()`` (which must return a ready-to-run program), timing it
    as build cost (``compile_seconds``, the reference's name). One
    instance per device (`global_cache`) is shared process-wide; tests
    and benchmarks may construct private ones to measure cold-cache
    behaviour.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[ExecutableKey, Callable] = {}  # guarded-by: _lock
        self._inflight: Dict[ExecutableKey, concurrent.futures.Future] = {}  # guarded-by: _lock
        self._generation = 0  # guarded-by: _lock — bumped by clear(); stale builds don't land
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._compile_seconds = 0.0  # guarded-by: _lock
        self._per_key: Dict[ExecutableKey, Dict[str, Any]] = {}  # guarded-by: _lock

    def get(self, key: ExecutableKey, builder: Callable[[], Callable]) -> Callable:
        with self._lock:
            exe = self._entries.get(key)
            if exe is not None:
                self._hits += 1
                self._per_key[key]["hits"] += 1
                return exe
            fut = self._inflight.get(key)
            owner = fut is None
            if owner:
                # we build; concurrent same-key callers wait on the future
                # (one build per key) while other keys — and hit-path
                # lookups — proceed: the lock is never held across a build
                fut = concurrent.futures.Future()
                self._inflight[key] = fut
                gen = self._generation
        if not owner:
            exe = fut.result()  # the owner's build is our reuse
            with self._lock:
                self._hits += 1
                if key in self._per_key:
                    self._per_key[key]["hits"] += 1
            return exe
        t0 = time.time()
        try:
            # Chaos seam: the "compile" fault site meters real build
            # attempts only (hits and future-waiters above never arrive
            # here), so an injected failure exercises exactly the
            # failed-build path: waiters see it, the key stays clean, and
            # the next get() retries.
            from repro_torch.serving import faults

            faults.fire("compile")
            exe = builder()
        except BaseException as e:
            # a failed build must not count as a build or wedge the key:
            # waiters see the error, the next get() retries the build
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        dt = time.time() - t0
        with self._lock:
            if self._generation == gen:
                self._entries[key] = exe
                self._misses += 1
                self._compile_seconds += dt
                self._per_key[key] = {"hits": 0, "compile_seconds": dt}
            # else: clear() ran mid-build — hand the program to our
            # waiters but keep it (and its counters) out of the wiped cache
            self._inflight.pop(key, None)
        fut.set_result(exe)
        return exe

    def clear(self) -> None:
        with self._lock:
            self._generation += 1  # builds in flight must not repopulate us
            self._entries.clear()
            self._per_key.clear()
            self._hits = self._misses = 0
            self._compile_seconds = 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "n_executables": len(self._entries),
                "compile_seconds": self._compile_seconds,
                "executables": {
                    getattr(k, "describe", lambda k=k: repr(k))(): dict(v)
                    for k, v in self._per_key.items()
                },
            }

    def counters(self) -> Dict[str, float]:
        """Lightweight hits/misses/compile-seconds snapshot (no per-key
        breakdown — cheap enough to take around every dispatch)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "compile_seconds": self._compile_seconds,
            }

    def delta_since(self, before: Dict[str, Any]) -> Dict[str, Any]:
        """Hits/misses/compile-seconds accumulated since a counters()/stats()
        snapshot."""
        now = self.counters()
        return {k: now[k] - before[k] for k in now}


_GLOBAL_LOCK = threading.Lock()
_GLOBAL_CACHES: Dict[torch.device, CompileCache] = {}


def device_key(device: DeviceLike) -> torch.device:
    """``device`` with its index made explicit ("cuda" is the current
    CUDA device), so that one card has one cache under any spelling."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def global_cache(device: DeviceLike = None) -> CompileCache:
    """The process-wide program cache of ``device`` (default: the current
    CUDA device) that every engine on it uses by default."""
    dev = device_key(device)
    with _GLOBAL_LOCK:
        cache = _GLOBAL_CACHES.get(dev)
        if cache is None:
            cache = _GLOBAL_CACHES[dev] = CompileCache()
        return cache
