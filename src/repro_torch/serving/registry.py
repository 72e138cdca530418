"""Model registry: resident SimNet predictors shared across all requests —
the port of ``repro.serving.registry``. Engines live on the registry's
``device`` (default ``cuda``); a ``mesh`` raises, as the port's programs
run on one device (ROADMAP item 12).

The paper's deployment model is train-once / simulate-everywhere; the
serving-side mirror is load-once / serve-everyone. A `ModelRegistry` keys
resident `SimNetEngine`s by model id: each predictor's weights are loaded
(from a `PredictorArtifact` directory or in-memory params) exactly once
and every request against that id reuses the same engine — and, through
the process-wide compile cache, same-architecture models reuse the same
compiled executables.

The special id ``TEACHER_FORCED`` is the resident label-replay "model"
(no weights): requests without a model id replay their DES labels through
the identical engine path.

A registry serves many client threads at once (the async `SimServe` path
submits and drains concurrently), so every check-then-act sequence holds
the registry lock: two racing ``ensure_teacher_forced`` calls resolve to
ONE resident engine instead of the loser dying on "already registered".
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.artifact import PredictorArtifact
from repro_torch.checkpoint.manager import ArtifactCorrupt
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.simulator import SimConfig
from repro_torch.serving.compile_cache import CompileCache
from repro_torch.serving.simnet_engine import SimNetEngine
from repro_torch.serving.telemetry import CircuitBreaker

TEACHER_FORCED = "teacher-forced"


class ModelRegistry:
    """Resident engines by model id. Construction-time ``use_kernel`` /
    ``cache`` / ``device`` apply to every engine the registry builds (an
    externally built engine can be adopted via `add_engine`); ``mesh``
    must be None.
    Thread-safe: admission, lookup and eviction serialize on one
    re-entrant lock (engine *construction* is cheap — compiles happen
    lazily at first dispatch, outside the registry).

    Each resident model owns a `CircuitBreaker`: the service records
    every batch outcome against it and fast-fails submits against a model
    whose breaker is open, so one repeatedly-failing artifact is isolated
    instead of detonating batch after batch inside the drain loop.
    Evicting a model drops its breaker too — a re-registered artifact
    starts with a clean slate."""

    def __init__(self, *, mesh=None, use_kernel: bool = False,
                 cache: Optional[CompileCache] = None,
                 breaker_threshold: int = 5, breaker_reset_s: float = 30.0,
                 clock=time.monotonic, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported: the port's programs run on one "
                "device (ExecutableKey.mesh is always None; ROADMAP item 12)"
            )
        self.mesh = mesh
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.cache = cache
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self._clock = clock
        self._lock = threading.RLock()  # add() nests into add_engine()
        self._engines: Dict[str, SimNetEngine] = {}  # guarded-by: _lock
        self._breakers: Dict[str, CircuitBreaker] = {}  # guarded-by: _lock

    # ------------------------------------------------------------- admission

    def add_engine(self, model_id: str, engine: SimNetEngine) -> str:
        """Adopt an already-built engine (e.g. a SimNet session's) as a
        resident model."""
        with self._lock:
            if model_id in self._engines and self._engines[model_id] is not engine:
                raise ValueError(f"model id {model_id!r} is already registered")
            self._engines[model_id] = engine
        return model_id

    def add(
        self,
        model_id: str,
        params=None,
        pcfg: Optional[PredictorConfig] = None,
        sim_cfg: Optional[SimConfig] = None,
    ) -> str:
        """Register in-memory weights (or a teacher-forced entry when
        ``params`` is None) as a resident model."""
        return self.add_engine(model_id, SimNetEngine(
            params, pcfg, sim_cfg, use_kernel=self.use_kernel,
            device=self.device, cache=self.cache,
        ))

    def load(self, model_id: str, path, sim_cfg: Optional[SimConfig] = None) -> str:
        """Load a `PredictorArtifact` directory once; all later requests
        against ``model_id`` share the resident weights."""
        try:
            art = PredictorArtifact.load(path, device=self.device)
        except ArtifactCorrupt:
            # Integrity guard: a corrupt artifact is isolated immediately —
            # force-open its breaker so submits against this id fast-fail
            # while every other resident keeps serving. No point counting
            # to the failure threshold: bit-rot does not heal on retry.
            self.breaker(model_id).trip("artifact corrupt")
            raise
        return self.add(
            model_id, params=art.params, pcfg=art.pcfg,
            sim_cfg=sim_cfg or art.sim_cfg,
        )

    def ensure_teacher_forced(self, sim_cfg: Optional[SimConfig] = None) -> str:
        # atomic check-then-add: two concurrent submits (model_id=None)
        # must resolve to one resident entry, not race each other into a
        # spurious "already registered" for the loser
        with self._lock:
            if TEACHER_FORCED not in self._engines:
                self.add(TEACHER_FORCED, sim_cfg=sim_cfg)
        return TEACHER_FORCED

    def remove(self, model_id: str) -> None:
        """Evict a resident model (frees its engine; a shared service
        hosting short-lived sessions should evict their entries)."""
        with self._lock:
            self._engines.pop(model_id, None)
            self._breakers.pop(model_id, None)

    # -------------------------------------------------------------- breakers

    def breaker(self, model_id: str) -> CircuitBreaker:
        """The model's circuit breaker (created lazily; survives as long
        as the model stays resident)."""
        with self._lock:
            br = self._breakers.get(model_id)
            if br is None:
                br = CircuitBreaker(
                    model_id, failure_threshold=self.breaker_threshold,
                    reset_after_s=self.breaker_reset_s, clock=self._clock,
                )
                self._breakers[model_id] = br
            return br

    def breaker_snapshots(self) -> Dict[str, dict]:
        with self._lock:
            breakers = dict(self._breakers)
        return {mid: br.snapshot() for mid, br in sorted(breakers.items())}

    # --------------------------------------------------------------- lookup

    def get(self, model_id: str) -> SimNetEngine:
        with self._lock:
            try:
                return self._engines[model_id]
            except KeyError:
                raise KeyError(
                    f"no resident model {model_id!r}; "
                    f"registered: {sorted(self._engines)}"
                ) from None

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._engines

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)

    def ids(self) -> Iterable[str]:
        with self._lock:
            return tuple(self._engines)
