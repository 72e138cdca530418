"""SimServe: a resident continuous-batching simulation service — the port
of ``repro.serving.service``. The scheduler is the reference's line for
line; the resident engines run on the service's ``device`` (default
``cuda``), each batch on the drain thread (or the watchdog's dispatch
thread), where the engine's CUDA graphs are built and replayed.

The paper's headline is throughput — one GPU-resident predictor amortized
over massive lane batches (§3.3). `SimServe` is that deployment shape as
an API: predictors stay resident in a `ModelRegistry`, compiled chunk
executables stay resident in the process-wide compile cache, and a job
queue continuously packs pending simulation requests — from *different*
clients and different models — into shared lane batches per resident
predictor, preserving per-workload results exactly.

    serve = SimServe()
    serve.register("c3", "artifacts/models/c3")      # loaded once, resident
    h1 = serve.submit(trace_a, "c3", n_lanes=8)      # JobHandle
    h2 = serve.submit(trace_b, "c3", n_lanes=4)      # same batch as h1
    h3 = serve.submit(trace_c)                       # teacher-forced replay
    serve.drain()                                    # run all pending packs
    h1.result()                                      # WorkloadResult
    serve.stats()                                    # jobs/batches/cache hits

Concurrent clients use the **background drain loop** instead of calling
``drain()`` themselves: ``start()`` (or ``with SimServe(...) as serve:``)
runs a scheduler thread that waits up to ``max_wait_ms`` after the first
pending job for batchmates to accumulate, then dispatches — round-robin
across resident models, so one chatty model cannot starve the rest — and
``JobHandle.result(timeout=...)`` / ``.wait()`` block on the job's own
completion event, never on a client-thread drain. ``max_queue_depth``
bounds the queue: ``submit`` raises `QueueFull` instead of buffering
without bound (backpressure the client can see and retry).

    with SimServe(max_queue_depth=256, max_wait_ms=5.0) as serve:
        serve.register("c3", "artifacts/models/c3")
        handles = [serve.submit(t, "c3") for t in traces]   # any thread
        totals = [h.result(timeout=60) for h in handles]    # never drains

The scheduler is QoS-aware: ``submit(..., priority=, deadline_ms=)``
rides each job into dispatch. Higher priority classes are served first
(with aging, so sustained high-priority load cannot starve the rest);
within a class, earliest-deadline-first; a job whose deadline expires
while still queued is failed loudly *before* dispatch (its handle raises
`DeadlineExceeded` — never a silent drop). Under light load the lane
budget shrinks below ``max_batch_lanes`` (``lane_budget_depth`` /
``min_batch_lanes``) to trade pack density back for latency — the
inverse knob of ``max_wait_ms``. Every batch outcome feeds the model's
`CircuitBreaker`: a repeatedly-failing artifact is isolated at submit
(`ModelUnavailable`) while the rest of the zoo keeps serving, and
latency/queue-depth/occupancy histograms plus per-job structured logs
(correlation ids) ride ``stats()``.

Single-session use is just a service with one client: `SimNet.simulate*`
routes through a private `SimServe` around the session's own engine
(``SimNet(background=True)`` runs it on the drain loop). Batch mode from
the shell: ``python -m repro_torch serve --jobs jobs.json [--async]``;
real concurrent clients go over the wire via `repro_torch.serving.http`.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import features as F
from repro_torch.core.results import WorkloadResult
from repro_torch.core.simulator import SimConfig, max_packed_steps
from repro_torch.serving.compile_cache import (
    CompileCache,
    chunk_bucket,
    global_cache,
    lane_bucket,
)
from repro_torch.serving import faults
from repro_torch.serving.registry import ModelRegistry
from repro_torch.serving.simnet_engine import NumericError
from repro_torch.serving.telemetry import Telemetry, log_event, new_correlation_id


class BatchTimeout(RuntimeError):
    """A batch dispatch exceeded ``batch_timeout_s``.

    The watchdog fails the hung batch's jobs (their handles raise this)
    and the drain loop keeps serving everyone else; the abandoned dispatch
    thread can never pin results onto the already-failed jobs."""


class QueueFull(RuntimeError):
    """``submit`` refused a job: the queue is at ``max_queue_depth``.

    Backpressure, not data loss — nothing was enqueued. Clients should
    retry after draining their outstanding handles (or run the service
    with a deeper queue / more drain capacity)."""


class DeadlineExceeded(RuntimeError):
    """The job's ``deadline_ms`` expired while it was still queued.

    The scheduler fails such jobs loudly *before* dispatch — the handle
    raises this instead of returning a result computed after the client
    stopped caring — and counts them in ``stats()["jobs_expired"]``."""


class ModelUnavailable(RuntimeError):
    """``submit`` refused a job: the model's circuit breaker is open.

    The resident artifact failed ``breaker_threshold`` consecutive
    batches and is isolated until its cooldown elapses (then one probe
    job is admitted). Other resident models keep serving."""


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """One shared lane batch the scheduler dispatched."""

    model_id: str
    job_ids: Tuple[int, ...]
    n_jobs: int
    n_live_lanes: int
    n_lanes: int  # bucketed (dead lanes = n_lanes - n_live_lanes)
    chunk: int
    total_instructions: int
    seconds: float
    first_call_seconds: float
    throughput_ips: float
    cache: Dict[str, Any]  # hit/miss/compile-seconds delta of this batch

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["job_ids"] = list(self.job_ids)
        return d


@dataclasses.dataclass
class _Job:
    job_id: int
    model_id: str
    trace: Any  # original TraceLike (kept for the DES-comparison readout)
    arrs: Dict[str, Any]
    name: str
    n_lanes: int
    sim_cfg: Optional[SimConfig]
    timeit: bool
    chunk: Optional[int]
    priority: int = 0
    deadline_ms: Optional[float] = None
    submit_t: float = 0.0  # service-clock timestamp of admission
    corr_id: str = ""  # correlation id stamped on every log record
    result: Optional[WorkloadResult] = None
    batch: Optional[BatchReport] = None
    error: Optional[BaseException] = None
    cancelled: bool = False
    # set exactly once, when the job reaches a terminal state (result
    # pinned, error pinned, or cancelled) — what result()/wait() block on
    done_evt: threading.Event = dataclasses.field(default_factory=threading.Event)


class JobHandle:
    """A submitted simulation request.

    ``result()`` blocks on the job's completion event when the service's
    background loop is running (or a ``timeout`` is given) — the client
    thread never executes other clients' jobs. Without a running loop and
    without a timeout it keeps the synchronous contract: drain inline,
    then return this workload's totals."""

    def __init__(self, service: "SimServe", job: _Job):
        self._service = service
        self._job = job

    @property
    def job_id(self) -> int:
        return self._job.job_id

    @property
    def model_id(self) -> str:
        return self._job.model_id

    @property
    def correlation_id(self) -> str:
        """The id every structured log record about this job carries."""
        return self._job.corr_id

    def done(self) -> bool:
        """True once the job reached a terminal state — completed, failed
        (its batch error is recorded), or cancelled."""
        return self._job.done_evt.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job is done (True) or ``timeout`` elapses
        (False). Never drains — pair with a started service."""
        return self._job.done_evt.wait(timeout)

    def _raise_terminal(self) -> None:
        if self._job.cancelled:
            raise RuntimeError(f"job {self.job_id} was cancelled")
        if isinstance(self._job.error, DeadlineExceeded):
            # not a batch failure — the scheduler refused to dispatch a
            # job nobody is waiting for anymore; raise it undecorated
            raise self._job.error
        if self._job.error is not None:
            # an already-failed job must re-raise its recorded batch error
            # immediately — draining here would run *unrelated* queued
            # jobs on this client's thread as a side effect
            raise RuntimeError(
                f"job {self.job_id} failed in its batch"
            ) from self._job.error

    def result(self, timeout: Optional[float] = None) -> WorkloadResult:
        self._raise_terminal()
        if self._job.result is None:
            if self._service.running or timeout is not None:
                if not self._job.done_evt.wait(timeout):
                    raise TimeoutError(
                        f"job {self.job_id} did not complete within "
                        f"{timeout}s (service running="
                        f"{self._service.running}, "
                        f"pending={self._service.pending})"
                    )
            else:
                self._service.drain()
                if not self._job.done_evt.is_set():
                    # another thread's drain holds it in an in-flight
                    # batch — wait for that dispatch to pin the outcome
                    self._job.done_evt.wait()
        self._raise_terminal()
        return self._job.result

    @property
    def batch(self) -> BatchReport:
        if self._job.batch is None:
            raise RuntimeError(f"job {self.job_id} has not run (call drain())")
        return self._job.batch

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return f"JobHandle({self.job_id}, model={self.model_id!r}, {state})"


class SimServe:
    """Job-queue scheduler over resident predictors.

    ``submit`` enqueues (bounded by ``max_queue_depth``); dispatch — via
    an explicit ``drain()`` or the background loop — repeatedly takes
    every compatible pending job of ONE resident model and runs them as
    one packed engine dispatch (lane-bucketed, so the compiled executable
    is shared with every other batch of the same shape and architecture).
    Jobs are compatible when they share the model and the SimConfig fields
    the packed scan cannot replay per lane (everything except
    ctx_len / retire_width, which pack per-lane). Models take turns
    round-robin: with several residents backed up, consecutive batches
    serve *different* models instead of emptying the head model's queue
    first.

    Dispatch order is QoS-aware on top of that fairness: the scheduler
    serves the highest *effective* priority class first (priority plus an
    aging bonus of +1 per ``aging_ms`` waited — the starvation guard),
    picks the earliest deadline inside that class (models with no
    deadlines at stake keep taking round-robin turns), fails
    deadline-expired jobs loudly before dispatch, and under light load
    shrinks the batch lane budget from ``max_batch_lanes`` toward
    ``min_batch_lanes`` (linear in queue depth up to
    ``lane_budget_depth``) so a near-idle service favors latency over
    pack density.
    """

    def __init__(
        self,
        registry: Optional[ModelRegistry] = None,
        *,
        chunk: int = 1024,
        max_batch_lanes: int = 4096,
        max_queue_depth: int = 0,
        max_wait_ms: float = 5.0,
        min_batch_lanes: int = 8,
        lane_budget_depth: int = 0,
        aging_ms: float = 1000.0,
        batch_timeout_s: float = 0.0,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 30.0,
        mesh=None,
        use_kernel: bool = False,
        cache: Optional[CompileCache] = None,
        clock=time.monotonic,
        device: DeviceLike = None,
    ):
        self._clock = clock
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else global_cache(self.device)
        self.registry = registry or ModelRegistry(
            mesh=mesh, use_kernel=use_kernel, cache=self.cache,
            breaker_threshold=breaker_threshold,
            breaker_reset_s=breaker_reset_s, clock=clock, device=self.device,
        )
        self.chunk = chunk
        self.max_batch_lanes = max_batch_lanes
        # 0 = unbounded; > 0: submit raises QueueFull past this many pending
        self.max_queue_depth = int(max_queue_depth)
        # batch window of the background loop: after the first pending job
        # is seen, wait this long for batchmates before dispatching
        # (latency traded for pack density; 0 dispatches immediately)
        self.max_wait_ms = float(max_wait_ms)
        # queue-depth-aware lane budgeting (the inverse of max_wait_ms):
        # below lane_budget_depth pending jobs, the effective lane cap
        # ramps linearly from min_batch_lanes up to max_batch_lanes, so a
        # lightly loaded service dispatches small low-latency batches
        # instead of hoarding lanes for density. 0 disables budgeting.
        self.min_batch_lanes = int(min_batch_lanes)
        self.lane_budget_depth = int(lane_budget_depth)
        # starvation guard: every aging_ms a job waits adds +1 to its
        # effective priority, so sustained high-priority traffic cannot
        # park low-priority jobs forever. 0 disables aging.
        self.aging_ms = float(aging_ms)
        # batch watchdog: a dispatch running longer than this fails its own
        # batch (BatchTimeout) instead of wedging the drain loop forever.
        # 0 disables the watchdog — dispatch runs inline on the drain
        # thread, exactly the pre-watchdog behaviour.
        self.batch_timeout_s = float(batch_timeout_s)
        self.telemetry = Telemetry(clock=clock)
        self._qlock = threading.Lock()  # guards _pending + counters + _rr
        self._pending: List[_Job] = []  # guarded-by: _qlock
        self._next_id = 0  # guarded-by: _qlock
        self._last_model: Optional[str] = None  # guarded-by: _qlock — round-robin cursor
        # recent dispatch history only — a resident service must not grow
        # per-batch state without bound; aggregates live in the counters
        self._batches: collections.deque = collections.deque(maxlen=256)  # guarded-by: _qlock
        self._n_batches = 0  # guarded-by: _qlock
        self._jobs_submitted = 0  # guarded-by: _qlock
        self._jobs_completed = 0  # guarded-by: _qlock
        self._jobs_rejected = 0  # guarded-by: _qlock — QueueFull refusals (admission honesty)
        self._jobs_expired = 0  # guarded-by: _qlock — deadline_ms ran out before dispatch
        self._jobs_breaker_rejected = 0  # guarded-by: _qlock — open-breaker fast-fails at submit
        self._jobs_failed_numeric = 0  # guarded-by: _qlock — numeric-guard batch failures
        self._batches_timed_out = 0  # guarded-by: _qlock — watchdog kills
        self._lanes_live = 0  # guarded-by: _qlock
        self._lanes_dispatched = 0  # guarded-by: _qlock
        self._dead_lane_steps = 0  # guarded-by: _qlock — bucketing overhead, for stats honesty
        # background drain loop
        self._lifecycle = threading.Lock()  # start/stop vs start/stop only
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._loop_errors = 0  # guarded-by: _qlock — batch failures the loop absorbed

    # ----------------------------------------------------------- admission

    def register(self, model_id: str, source=None, *,
                 params=None, pcfg=None, sim_cfg=None) -> str:
        """Make a model resident. ``source`` may be a PredictorArtifact
        directory path, a PredictorArtifact, or None with params/pcfg
        (or nothing at all: a teacher-forced entry)."""
        from repro_torch.checkpoint.artifact import PredictorArtifact

        if isinstance(source, PredictorArtifact):
            return self.registry.add(
                model_id, params=source.params, pcfg=source.pcfg,
                sim_cfg=sim_cfg or source.sim_cfg,
            )
        if source is not None:  # a path
            return self.registry.load(model_id, source, sim_cfg=sim_cfg)
        return self.registry.add(model_id, params=params, pcfg=pcfg, sim_cfg=sim_cfg)

    def register_engine(self, model_id: str, engine) -> str:
        return self.registry.add_engine(model_id, engine)

    # ----------------------------------------------------------- lifecycle

    @property
    def running(self) -> bool:
        """True while the background drain loop is serving the queue."""
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SimServe":
        """Run the drain loop on a background thread. Idempotent; returns
        self so ``with SimServe(...).start():`` and chained construction
        read naturally."""
        with self._lifecycle:
            if self.running:
                return self
            self._stop_evt = threading.Event()
            self._wake = threading.Event()
            self._thread = threading.Thread(
                target=self._drain_loop, name="simserve-drain", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the background loop (joins the thread). ``drain=True``
        (default) then runs any still-pending jobs inline so no accepted
        job is abandoned; their handles complete or carry errors.

        With a ``timeout`` the join may expire while the loop is still
        finishing its current batch: the thread then stays tracked
        (``running`` remains True, no inline drain races it) and a later
        ``stop()`` completes the shutdown."""
        with self._lifecycle:
            t = self._thread
            if t is not None:
                self._stop_evt.set()
                self._wake.set()
                t.join(timeout)
                if t.is_alive():
                    return  # mid-batch; try again — never drain concurrently
                self._thread = None
        if drain:
            self.drain()

    def __enter__(self) -> "SimServe":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def _drain_loop(self) -> None:
        """The scheduler thread: sleep until work shows up, give
        batchmates ``max_wait_ms`` to accumulate, dispatch everything,
        repeat. A failed batch pins its error on its own jobs (their
        handles re-raise it); the loop keeps serving everyone else."""
        while not self._stop_evt.is_set():
            self._wake.wait(0.05)  # submit() wakes us early; 50 ms fallback
            self._wake.clear()
            if self._stop_evt.is_set():
                return
            with self._qlock:
                has_work = bool(self._pending)
            if not has_work:
                continue
            if self.max_wait_ms > 0:
                self._stop_evt.wait(self.max_wait_ms / 1000.0)
            try:
                self.drain()
            except BaseException:
                # already pinned on the failed batch's handles by drain().
                # BaseException: the scheduler must outlive even a stray
                # KeyboardInterrupt/SystemExit raised into this thread —
                # dying silently would strand every blocked result() call
                with self._qlock:
                    self._loop_errors += 1

    # ------------------------------------------------------------ the queue

    def submit(
        self,
        trace,
        model_id: Optional[str] = None,
        *,
        n_lanes: int = 8,
        sim_cfg: Optional[SimConfig] = None,
        name: Optional[str] = None,
        timeit: bool = False,
        chunk: Optional[int] = None,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
    ) -> JobHandle:
        """Enqueue one workload against a resident model (None = the
        teacher-forced resident). Returns immediately; the job runs at the
        next dispatch packed together with every compatible request.

        ``priority`` (higher = served sooner; default 0) and
        ``deadline_ms`` (fail the job loudly if still queued this many ms
        after submit; None = no deadline) ride into the scheduler.
        Raises `QueueFull` when ``max_queue_depth`` pending jobs are
        already buffered and `ModelUnavailable` when the model's circuit
        breaker is open — nothing is enqueued in either case."""
        if model_id is None:
            model_id = self.registry.ensure_teacher_forced()
        elif model_id not in self.registry:
            raise KeyError(
                f"no resident model {model_id!r}; register() it first "
                f"(registered: {sorted(self.registry.ids())})"
            )
        if sim_cfg is not None:
            # ctx_len / retire_width replay per lane inside the pack; every
            # other SimConfig field is baked into the resident executable —
            # a mismatch must fail loudly here, not simulate with the
            # engine's values
            eng_cfg = self.registry.get(model_id).sim_cfg
            if sim_cfg.layout != eng_cfg.layout:
                # the step layout is compiled into the resident executable
                # (it rides the compile-cache key) and cannot replay per
                # lane — name it specifically rather than the generic
                # config-mismatch message below
                raise ValueError(
                    f"job SimConfig layout {sim_cfg.layout!r} differs from "
                    f"resident model {model_id!r} layout {eng_cfg.layout!r}: "
                    "a resident engine runs ONE step layout — submit with "
                    "the engine's layout or register a model with the "
                    "wanted one"
                )
            if dataclasses.replace(
                sim_cfg, ctx_len=eng_cfg.ctx_len, retire_width=eng_cfg.retire_width
            ) != eng_cfg:
                raise ValueError(
                    f"job SimConfig {sim_cfg} is incompatible with resident "
                    f"model {model_id!r} ({eng_cfg}): only ctx_len/retire_width "
                    "may differ — register a model with the wanted config"
                )
            if sim_cfg.ctx_len > eng_cfg.ctx_len:
                raise ValueError(
                    f"job ctx_len {sim_cfg.ctx_len} exceeds resident model "
                    f"{model_id!r} ctx_len {eng_cfg.ctx_len} (the predictor "
                    "input width is fixed)"
                )
        arrs = trace if isinstance(trace, dict) else F.trace_arrays(trace)
        T = int(arrs["feat"].shape[0])
        if not 1 <= n_lanes <= T:
            # statically invalid jobs must be refused here — at drain they
            # would detonate the shared batch and poison valid batchmates
            raise ValueError(
                f"n_lanes={n_lanes} invalid for a {T}-instruction workload "
                "(need 1 <= n_lanes <= instructions)"
            )
        # circuit breaker: a model that failed its last breaker_threshold
        # batches is isolated HERE — fast-fail at admission, the drain
        # loop is never touched. Checked after the static validations so
        # an invalid request cannot consume the half-open probe slot.
        if not self.registry.breaker(model_id).allow():
            with self._qlock:
                self._jobs_breaker_rejected += 1
            log_event("job.rejected", level=logging.WARNING,
                      reason="breaker_open", model=model_id)
            raise ModelUnavailable(
                f"model {model_id!r} is isolated: its circuit breaker is "
                f"open after repeated batch failures "
                f"({self.registry.breaker(model_id).snapshot()}); retry "
                "after the cooldown or register a fixed artifact"
            )
        with self._qlock:
            if self.max_queue_depth and len(self._pending) >= self.max_queue_depth:
                self._jobs_rejected += 1
                log_event("job.rejected", level=logging.WARNING,
                          reason="queue_full", model=model_id,
                          queue_depth=len(self._pending))
                raise QueueFull(
                    f"queue is full ({len(self._pending)} pending >= "
                    f"max_queue_depth={self.max_queue_depth}); job refused — "
                    "wait on outstanding handles and retry"
                )
            job_id = self._next_id
            self._next_id += 1
            job = _Job(
                job_id=job_id,
                model_id=model_id,
                trace=trace,
                arrs=arrs,
                # the default name derives from the already-unique job_id,
                # minted under the lock — a shared counter read outside it
                # minted colliding names under concurrent submits
                name=name or getattr(trace, "name", None) or f"job{job_id}",
                n_lanes=int(n_lanes),
                sim_cfg=sim_cfg,
                timeit=timeit,
                chunk=chunk,
                priority=int(priority),
                deadline_ms=None if deadline_ms is None else float(deadline_ms),
                submit_t=self._clock(),
                corr_id=new_correlation_id(),
            )
            self._pending.append(job)
            self._jobs_submitted += 1
            depth = len(self._pending)
        self.telemetry.queue_depth.observe(depth)
        log_event("job.submit", job_id=job.job_id, correlation_id=job.corr_id,
                  model=model_id, name=job.name, n_lanes=job.n_lanes,
                  priority=job.priority, deadline_ms=job.deadline_ms,
                  queue_depth=depth)
        self._wake.set()  # the background loop opens its batch window now
        return JobHandle(self, job)

    def cancel(self, handle: JobHandle) -> bool:
        """Withdraw a still-pending job from the queue (False if it already
        ran or left the queue — an in-flight batch cannot be recalled).
        Lets a client unwind a multi-submit that failed halfway instead of
        leaving orphans for the next batch."""
        with self._qlock:
            for i, job in enumerate(self._pending):
                if job is handle._job:
                    del self._pending[i]
                    job.cancelled = True  # result() raises, never None
                    job.done_evt.set()
                    return True
        return False

    def _group_key(self, job: _Job):
        """Jobs sharing a key may ride one packed scan: same resident
        model and same timeit mode. (The non-per-lane SimConfig fields are
        already guaranteed by submit() to match the resident engine's.)"""
        return (job.model_id, job.timeit)

    def _effective_priority(self, job: _Job, now: float) -> int:
        """Base priority plus the aging bonus (+1 per ``aging_ms``
        waited) — the starvation guard that drags long-parked jobs up
        through sustained higher-priority traffic."""
        if self.aging_ms > 0:
            waited_ms = max(0.0, (now - job.submit_t) * 1000.0)
            return job.priority + int(waited_ms / self.aging_ms)
        return job.priority

    def _lane_budget(self, depth: int) -> int:
        """The effective live-lane cap at this queue depth. Light load →
        small batches (latency); at/above ``lane_budget_depth`` pending
        jobs → the full ``max_batch_lanes`` (density)."""
        if self.lane_budget_depth <= 0 or depth >= self.lane_budget_depth:
            return self.max_batch_lanes
        scaled = int(self.max_batch_lanes * depth / self.lane_budget_depth)
        return max(1, min(self.min_batch_lanes, self.max_batch_lanes), scaled)

    @staticmethod
    def _deadline_at(job: _Job) -> float:
        return (math.inf if job.deadline_ms is None
                else job.submit_t + job.deadline_ms / 1000.0)

    def _take_batch(self) -> Tuple[Optional[Tuple], List[_Job]]:
        """Atomically pop the next batch, QoS-aware.

        First, every queued job whose deadline already passed is failed
        loudly (error pinned, counted — never dispatched, never silently
        dropped). Then the scheduler picks the group to serve: among the
        jobs of the highest *effective* priority (base + aging bonus),
        the one with the earliest deadline wins; with no deadlines at
        stake, models keep taking round-robin turns (per-model fairness —
        a model with a deep backlog cannot starve the others). The chosen
        group's jobs pack in QoS order (priority desc, deadline asc,
        FIFO) up to the queue-depth-aware lane budget."""
        now = self._clock()
        expired: List[_Job] = []
        key: Optional[Tuple] = None
        batch: List[_Job] = []
        with self._qlock:
            if any(j.deadline_ms is not None for j in self._pending):
                live = []
                for job in self._pending:
                    if self._deadline_at(job) < now:
                        expired.append(job)
                    else:
                        live.append(job)
                if expired:
                    self._pending = live
                    self._jobs_expired += len(expired)
            if self._pending:
                eff = {j.job_id: self._effective_priority(j, now)
                       for j in self._pending}
                top = max(eff.values())
                top_jobs = [j for j in self._pending if eff[j.job_id] == top]
                if any(j.deadline_ms is not None for j in top_jobs):
                    # earliest deadline first across the top class
                    lead = min(top_jobs,
                               key=lambda j: (self._deadline_at(j), j.job_id))
                    key = self._group_key(lead)
                else:
                    keys: List[Tuple] = []
                    for job in top_jobs:
                        k = self._group_key(job)
                        if k not in keys:
                            keys.append(k)
                    key = self._next_group(keys)
                budget = self._lane_budget(len(self._pending))
                group = sorted(
                    (j for j in self._pending if self._group_key(j) == key),
                    key=lambda j: (-eff[j.job_id], self._deadline_at(j),
                                   j.job_id),
                )
                lanes = 0
                for job in group:
                    # the first job of the group always rides (a single
                    # job wider than the cap gets its own batch — it must
                    # not wedge the queue)
                    if not batch or lanes + job.n_lanes <= budget:
                        batch.append(job)
                        lanes += job.n_lanes
                taken = {id(j) for j in batch}
                self._pending = [j for j in self._pending
                                 if id(j) not in taken]
                self._last_model = key[0]
        for job in expired:
            waited_ms = (now - job.submit_t) * 1000.0
            job.error = DeadlineExceeded(
                f"job {job.job_id} ({job.name!r}) missed its deadline: "
                f"queued {waited_ms:.0f} ms > deadline_ms={job.deadline_ms:g} "
                "— failed before dispatch"
            )
            job.done_evt.set()
            log_event("job.deadline_expired", level=logging.WARNING,
                      job_id=job.job_id, correlation_id=job.corr_id,
                      model=job.model_id, waited_ms=waited_ms,
                      deadline_ms=job.deadline_ms)
        return key, batch

    def _next_group(self, keys: Sequence[Tuple]) -> Tuple:
        """Round-robin across models: the waiting group whose model id is
        the cyclic successor of the last-served one (queue order breaks
        ties between groups of the same model)."""
        if self._last_model is None:
            return keys[0]
        models = sorted({k[0] for k in keys})
        nxt = next((m for m in models if m > self._last_model), models[0])
        return next(k for k in keys if k[0] == nxt)

    def drain(self) -> List[BatchReport]:
        """Run every pending job on the calling thread. Each iteration
        packs one model's compatible pending jobs (round-robin across
        models, FIFO within one, capped at ``max_batch_lanes`` live lanes)
        into one engine dispatch.

        Returns the reports of the batches THIS call ran. If a batch
        fails mid-drain the error propagates; batches completed before it
        stay recorded in ``self.batches`` / the counters (only the failed
        batch's jobs carry the error), and the untouched remainder of the
        queue drains on the next call."""
        reports: List[BatchReport] = []
        while True:
            key, batch = self._take_batch()
            if key is None:
                break
            try:
                reports.append(self._run_batch(key[0], batch))
            except BaseException as e:
                # the batch's jobs already left the queue — pin the error on
                # each so result() raises instead of returning None, then
                # surface it (the remaining queue drains on the next call).
                # BaseException on purpose: a KeyboardInterrupt mid-compile
                # must not leave waiters blocked on unpinned jobs forever
                for job in batch:
                    job.error = e
                    job.done_evt.set()
                self.registry.breaker(key[0]).record_failure()
                if isinstance(e, NumericError):
                    # numeric guard: the engine refused NaN/Inf totals —
                    # count loudly; silent CPI corruption is the one
                    # failure mode observability cannot recover from
                    with self._qlock:
                        self._jobs_failed_numeric += len(batch)
                    log_event("batch.numeric_failure", level=logging.ERROR,
                              model=key[0],
                              bad_workloads=e.bad_workloads,
                              job_ids=[j.job_id for j in batch],
                              correlation_ids=[j.corr_id for j in batch])
                log_event("batch.failed", level=logging.ERROR,
                          model=key[0], job_ids=[j.job_id for j in batch],
                          correlation_ids=[j.corr_id for j in batch],
                          error=repr(e))
                raise
        return reports

    def _run_batch(self, model_id: str, jobs: List[_Job]) -> BatchReport:
        engine = self.registry.get(model_id)
        t_dispatch = self._clock()
        for j in jobs:
            self.telemetry.queue_wait_ms.observe(
                (t_dispatch - j.submit_t) * 1000.0
            )
        arrs = [j.arrs for j in jobs]
        lanes = [j.n_lanes for j in jobs]
        cfgs = [j.sim_cfg or engine.sim_cfg for j in jobs]
        cap = min(j.chunk or self.chunk for j in jobs)
        chunk = chunk_bucket(max_packed_steps(arrs, lanes), cap)
        timeit = jobs[0].timeit

        def dispatch():
            # chaos seam: delay_ms simulates a hung dispatch (watchdog
            # prey), fail an engine that detonates mid-batch
            faults.fire("batch.execute")
            return engine.simulate_many(
                arrs, n_lanes=lanes, chunk=chunk, cfgs=cfgs, timeit=timeit
            )

        res = self._dispatch_guarded(model_id, jobs, dispatch)
        report = BatchReport(
            model_id=model_id,
            job_ids=tuple(j.job_id for j in jobs),
            n_jobs=len(jobs),
            n_live_lanes=int(res["n_live_lanes"]),
            n_lanes=int(res["n_lanes"]),
            chunk=chunk,
            total_instructions=int(res["total_instructions"]),
            seconds=float(res["seconds"]),
            first_call_seconds=float(res["first_call_seconds"]),
            throughput_ips=float(res["throughput_ips"]),
            cache=dict(res["cache"]),
        )
        t_done = self._clock()
        for i, job in enumerate(jobs):
            job.result = self._workload_result(job, res, i)
            job.batch = report
            job.done_evt.set()  # result is pinned — waiters may wake now
            self.telemetry.service_ms.observe((t_done - job.submit_t) * 1000.0)
            log_event("job.complete", job_id=job.job_id,
                      correlation_id=job.corr_id, model=model_id,
                      name=job.name, total_cycles=job.result.total_cycles,
                      latency_ms=(t_done - job.submit_t) * 1000.0)
        self.telemetry.batch_jobs.observe(len(jobs))
        self.registry.breaker(model_id).record_success()
        log_event("batch.dispatch", model=model_id, n_jobs=len(jobs),
                  n_live_lanes=report.n_live_lanes, n_lanes=report.n_lanes,
                  seconds=report.seconds,
                  correlation_ids=[j.corr_id for j in jobs])
        with self._qlock:  # concurrent drains must not lose counter updates
            self._jobs_completed += len(jobs)
            self._lanes_live += report.n_live_lanes
            self._lanes_dispatched += report.n_lanes
            self._dead_lane_steps += (
                report.n_lanes - report.n_live_lanes
            ) * int(res["n_steps"])  # padded steps the dispatch actually ran
            self._n_batches += 1
            self._batches.append(report)
        return report

    def _dispatch_guarded(self, model_id: str, jobs: List[_Job], dispatch):
        """Run one engine dispatch under the batch watchdog.

        With ``batch_timeout_s`` unset the call is inline (zero overhead,
        pre-watchdog semantics). Otherwise the dispatch runs on a fresh
        daemon thread and a join deadline guards it: on expiry the batch
        fails with `BatchTimeout` while the abandoned thread finishes (or
        hangs) harmlessly — its result lands in a dead box, never on the
        jobs, because all result-pinning happens on the caller after a
        successful join. Real wall clock on purpose: the watchdog guards
        against actual hangs, not simulated time."""
        if self.batch_timeout_s <= 0:
            return dispatch()
        box: Dict[str, Any] = {}

        def worker():
            try:
                box["res"] = dispatch()
            except BaseException as e:  # hand *any* failure to the caller
                box["err"] = e

        t = threading.Thread(
            target=worker, name="simserve-dispatch", daemon=True
        )
        t.start()
        t.join(self.batch_timeout_s)
        if t.is_alive():
            with self._qlock:
                self._batches_timed_out += 1
            log_event("batch.watchdog", level=logging.ERROR,
                      model=model_id, timeout_s=self.batch_timeout_s,
                      job_ids=[j.job_id for j in jobs],
                      correlation_ids=[j.corr_id for j in jobs])
            raise BatchTimeout(
                f"batch for model {model_id!r} exceeded "
                f"{self.batch_timeout_s:g}s ({len(jobs)} jobs)"
            )
        if "err" in box:
            raise box["err"]
        return box["res"]

    @staticmethod
    def _workload_result(job: _Job, res: dict, i: int) -> WorkloadResult:
        cycles = float(res["workload_cycles"][i])
        n = int(res["n_instructions"][i])
        kw: Dict[str, Any] = {}
        ref_lat = getattr(job.trace, "fetch_lat", None)
        if ref_lat is not None and ref_lat.any():
            ref = job.trace.total_cycles
            des_cpi = ref / job.trace.n
            kw = {
                "des_cycles": ref,
                "des_cpi": des_cpi,
                "cpi_error": abs(cycles / n - des_cpi) / des_cpi,
            }
        return WorkloadResult(
            name=job.name,
            total_cycles=cycles,
            cpi=cycles / n,
            n_instructions=n,
            n_lanes=job.n_lanes,
            overflow=int(res["workload_overflow"][i]),
            **kw,
        )

    # -------------------------------------------------------------- readout

    @property
    def pending(self) -> int:
        # len() alone is atomic under the GIL, but the drain loop swaps
        # _pending wholesale in _take_batch — take the lock so a reader
        # never sees the queue mid-swap
        with self._qlock:
            return len(self._pending)

    @property
    def batches(self) -> Tuple[BatchReport, ...]:
        """The most recent dispatches (bounded history; counters in
        ``stats()`` cover the service's whole lifetime)."""
        # the drain loop appends concurrently; tuple(deque) mid-append
        # can raise or tear — snapshot under the queue lock
        with self._qlock:
            return tuple(self._batches)

    def stats(self) -> Dict[str, Any]:
        """A consistent snapshot of the service counters.

        The counter block is copied under the queue lock — a dispatch
        updating several counters can never be observed halfway through
        (torn reads used to show e.g. ``jobs_completed`` bumped before
        ``batches``, making ``jobs_per_batch`` momentarily wrong). The
        telemetry histograms snapshot lock-free on their own seqlocks."""
        with self._qlock:
            snap: Dict[str, Any] = {
                "jobs_submitted": self._jobs_submitted,
                "jobs_completed": self._jobs_completed,
                "jobs_rejected": self._jobs_rejected,
                "jobs_expired": self._jobs_expired,
                "jobs_breaker_rejected": self._jobs_breaker_rejected,
                "jobs_failed_numeric": self._jobs_failed_numeric,
                "batches_timed_out": self._batches_timed_out,
                "jobs_pending": len(self._pending),
                "batches": self._n_batches,
                "lanes_live": self._lanes_live,
                "lanes_dispatched": self._lanes_dispatched,
                "dead_lane_steps": self._dead_lane_steps,
                "jobs_per_batch": (
                    self._jobs_completed / self._n_batches
                    if self._n_batches else 0.0
                ),
                "loop_errors": self._loop_errors,
            }
        snap.update({
            "models_resident": sorted(self.registry.ids()),
            "running": self.running,
            "max_queue_depth": self.max_queue_depth,
            "max_wait_ms": self.max_wait_ms,
            "min_batch_lanes": self.min_batch_lanes,
            "lane_budget_depth": self.lane_budget_depth,
            "aging_ms": self.aging_ms,
            "batch_timeout_s": self.batch_timeout_s,
            "telemetry": self.telemetry.snapshot(),
            "breakers": self.registry.breaker_snapshots(),
            "cache": self.cache.stats(),
            "faults": faults.snapshot(),  # None unless a chaos plan is live
        })
        return snap
