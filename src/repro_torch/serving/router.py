"""The fleet router: one `/v1/*` wire surface over N SimServe replicas —
the port of ``repro.serving.router`` (framework-free: it speaks HTTP to
replicas and never touches a device).

One SimServe process is a hard ceiling — one registry, one queue, one
host's memory for the model zoo. The paper's throughput claim (and
NeuroScalar's deployment-scale reading of it) wants a *fleet*: many
replica processes, each a complete HTTP SimServe, behind a router that
clients cannot tell apart from a single instance. This module is that
router, stdlib-only like the rest of the serving tier.

What the router does:

- **Replica registry.** Each replica's resident model ids are discovered
  via ``GET /v1/models`` and refreshed by a background poll, so placement
  is model-aware: a job for model ``m`` only considers replicas hosting
  ``m`` (teacher-forced jobs run anywhere).
- **Power-of-two-choices balancing.** Among the candidate replicas, pick
  two at random and route to the one with the lower cached queue depth
  (from the periodic ``/v1/stats`` polls, bumped optimistically on every
  accepted job). Classic p2c: almost all of the benefit of
  join-shortest-queue at a fraction of the coordination.
- **Failure as policy.** A replica answering 429 `QueueFull` is *full*,
  not broken — the job fails over to the next candidate, and only if every
  candidate is full does the client see the 429 (backpressure end to
  end). A connection-refused / 503 replica is *gone* — it is ejected from
  rotation and a background prober knocks on ``/v1/healthz`` with
  exponential backoff until the replica answers again, then readmits it.
- **Transparent job ids.** Router job ids encode ``(replica, local_id)``
  as ``"r0:17"``, so ``GET /v1/jobs/<id>`` proxies straight to the
  owning replica; if that replica has been ejected the poll answers a
  structured 503 ``replica_unavailable`` — the signal `route_jobs`
  clients use to resubmit the job to a survivor.
- **Aggregated observability.** ``GET /v1/stats`` merges the fleet:
  per-replica snapshots, summed service counters, and fleet-wide latency
  histograms (`telemetry.merge_snapshots` — fixed buckets add exactly),
  plus the router's own counters (routed / failovers / ejections /
  readmissions).

    router = FleetRouter(["http://127.0.0.1:7001", "http://127.0.0.1:7002"])
    with router:                       # binds, discovers, starts the prober
        print(router.url)              # clients speak plain /v1/* to this
        ...

Process management (spawning the replicas themselves) lives in
`repro_torch.serving.fleet`; ``python -m repro_torch fleet`` wires both to
the shell.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.backoff import Backoff
from repro_torch.serving.http import (
    ApiError,
    JsonHandler,
    TransportError,
    http_request,
)
from repro_torch.serving.registry import TEACHER_FORCED
from repro_torch.serving.telemetry import log_event, merge_snapshots

# the counter keys of SimServe.stats() that add across replicas
_SUMMED_COUNTERS = (
    "jobs_submitted", "jobs_completed", "jobs_rejected", "jobs_expired",
    "jobs_breaker_rejected", "jobs_failed_numeric", "batches_timed_out",
    "jobs_pending", "batches", "lanes_live",
    "lanes_dispatched", "dead_lane_steps", "loop_errors",
)
_HISTOGRAMS = ("queue_wait_ms", "service_ms", "queue_depth", "batch_jobs")


@dataclasses.dataclass
class ReplicaState:
    """The router's view of one replica. Mutated only under the router
    lock; the HTTP calls that feed it happen outside the lock."""

    name: str
    url: str
    healthy: bool = False
    models: Tuple[str, ...] = ()
    queue_depth: int = 0  # cached depth for p2c (stats polls + optimistic bumps)
    last_stats: Optional[Dict[str, Any]] = None
    last_poll_t: float = -1e18  # forces an immediate first poll
    next_probe_t: float = 0.0
    probe_backoff: Backoff = None  # type: ignore[assignment]
    ejections: int = 0
    open_breakers: Tuple[str, ...] = ()  # degraded-health detail

    @property
    def status(self) -> str:
        if not self.healthy:
            return "down"
        return "degraded" if self.open_breakers else "ok"

    def snapshot(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "healthy": self.healthy,
            "status": self.status,
            "open_breakers": sorted(self.open_breakers),
            "models": sorted(self.models),
            "queue_depth": self.queue_depth,
            "ejections": self.ejections,
        }


class FleetRouter:
    """`/v1/*` over N replicas: model-aware p2c placement, failover,
    ejection + probed readmission, aggregated stats.

    ``replica_urls`` name the replicas (``r0``, ``r1``, ... in order);
    replicas that are down at ``start()`` simply begin ejected and are
    readmitted by the prober when they come up — the router never refuses
    to start because part of the fleet is missing."""

    def __init__(
        self,
        replica_urls: Sequence[str],
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        poll_interval_s: float = 0.25,
        probe_initial_s: float = 0.05,
        probe_cap_s: float = 2.0,
        request_timeout_s: float = 600.0,
        rng: Optional[random.Random] = None,
        clock=time.monotonic,
    ):
        if not replica_urls:
            raise ValueError("a router needs at least one replica URL")
        self.host = host
        self.port = int(port)  # rebound to the real port by start()
        self.poll_interval_s = float(poll_interval_s)
        self.probe_initial_s = float(probe_initial_s)
        self.probe_cap_s = max(float(probe_cap_s), float(probe_initial_s))
        self.request_timeout_s = float(request_timeout_s)
        self._rng = rng or random.Random()
        self._clock = clock
        self.replicas: List[ReplicaState] = [
            ReplicaState(
                name=f"r{i}", url=u.rstrip("/"),
                probe_backoff=Backoff(self.probe_initial_s, self.probe_cap_s),
            )
            for i, u in enumerate(replica_urls)
        ]
        self._by_name = {r.name: r for r in self.replicas}
        self._lock = threading.RLock()
        self._jobs_routed = 0  # guarded-by: _lock
        self._routed_per_replica = {r.name: 0 for r in self.replicas}  # guarded-by: _lock
        self._failovers = 0  # guarded-by: _lock — candidates skipped past (429 or ejection)
        self._ejections = 0  # guarded-by: _lock
        self._readmissions = 0  # guarded-by: _lock
        self._jobs_unroutable = 0  # guarded-by: _lock — no candidate could take the job
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # merged into /v1/stats as "supervisor": the process manager
        # (serving.fleet) hangs its restart counters here so replica
        # lifecycle is observable through the same wire surface
        self.extra_stats = None  # Optional[Callable[[], Dict[str, Any]]]

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        now = self._clock()
        for r in self.replicas:
            self._probe(r, now, count_readmission=False)
        self._stop_evt = threading.Event()
        self._httpd = ThreadingHTTPServer((self.host, self.port), _RouterHandler)
        self._httpd.daemon_threads = True
        self._httpd.frontend = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router", daemon=True
        )
        self._thread.start()
        self._prober = threading.Thread(
            target=self._prober_loop, name="fleet-prober", daemon=True
        )
        self._prober.start()
        log_event("router.start", level=logging.INFO, host=self.host,
                  port=self.port, replicas=[r.url for r in self.replicas])
        return self.port

    def stop(self) -> None:
        self._stop_evt.set()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        for t in (self._thread, self._prober):
            if t is not None:
                t.join(timeout=10)
        self._thread = self._prober = None
        log_event("router.stop", level=logging.INFO, port=self.port)

    def __enter__(self) -> "FleetRouter":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -------------------------------------------------- replica bookkeeping

    def _eject(self, r: ReplicaState, reason: str) -> None:
        """Take a replica out of rotation; the prober owns readmission."""
        now = self._clock()
        with self._lock:
            if not r.healthy:
                return
            r.healthy = False
            r.ejections += 1
            self._ejections += 1
            r.probe_backoff.reset()
            r.next_probe_t = now + r.probe_backoff.next()
        log_event("router.eject", level=logging.WARNING, replica=r.name,
                  url=r.url, reason=reason)

    def _probe(self, r: ReplicaState, now: float,
               count_readmission: bool = True) -> bool:
        """One health probe: ``/v1/healthz`` then a ``/v1/models``
        refresh. Success readmits the replica; failure pushes the next
        probe out on the replica's exponential backoff."""
        try:
            status, hz = http_request(f"{r.url}/v1/healthz", timeout=5.0)
            if status == 200:
                _, models = http_request(f"{r.url}/v1/models", timeout=5.0)
                st, stats = http_request(f"{r.url}/v1/stats", timeout=5.0)
                with self._lock:
                    was_down = not r.healthy
                    r.healthy = True
                    r.models = tuple(models.get("models", ()))
                    r.open_breakers = tuple(hz.get("open_breakers", ()))
                    if st == 200:
                        r.last_stats = stats
                        r.queue_depth = int(stats.get("jobs_pending", 0))
                    r.last_poll_t = now
                    r.probe_backoff.reset()
                    if was_down and count_readmission:
                        self._readmissions += 1
                if was_down and count_readmission:
                    log_event("router.readmit", level=logging.WARNING,
                              replica=r.name, url=r.url)
                return True
        except TransportError:
            pass
        with self._lock:
            r.healthy = False
            r.next_probe_t = now + r.probe_backoff.next()
        return False

    def _poll_stats(self, r: ReplicaState, now: float) -> None:
        """Refresh one healthy replica's cached stats (queue depth feeds
        p2c; models may have changed). Unreachable → eject."""
        try:
            st, stats = http_request(f"{r.url}/v1/stats", timeout=5.0)
            _, models = http_request(f"{r.url}/v1/models", timeout=5.0)
        except TransportError as e:
            self._eject(r, f"stats poll failed: {e}")
            return
        with self._lock:
            r.last_poll_t = now
            if st == 200:
                r.last_stats = stats
                r.queue_depth = int(stats.get("jobs_pending", 0))
                r.models = tuple(models.get("models", r.models))
                # degraded detail rides the stats poll: any resident
                # breaker open → the replica serves but is impaired
                r.open_breakers = tuple(sorted(
                    mid for mid, snap in (stats.get("breakers") or {}).items()
                    if isinstance(snap, dict) and snap.get("state") == "open"
                ))

    def _prober_loop(self) -> None:
        """The background thread that owns liveness: periodic stats polls
        for healthy replicas, backoff-spaced healthz probes for ejected
        ones."""
        tick = min(0.02, self.probe_initial_s, self.poll_interval_s)
        while not self._stop_evt.wait(tick):
            now = self._clock()
            for r in self.replicas:
                if self._stop_evt.is_set():
                    return
                if r.healthy:
                    if now - r.last_poll_t >= self.poll_interval_s:
                        self._poll_stats(r, now)
                elif now >= r.next_probe_t:
                    self._probe(r, now)

    # ------------------------------------------------------------ placement

    def _placement_order(self, model: Optional[str],
                         pinned: Optional[str]) -> List[ReplicaState]:
        """The candidates for this job, in try-order: the p2c winner
        first, then the loser, then the rest by ascending cached depth —
        failover walks this list. A ``pinned`` replica (tests, ops
        drains) goes first but failover past it still works."""
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            if model in (None, TEACHER_FORCED):
                cands = list(healthy)
            else:
                cands = [r for r in healthy if model in r.models]
            depths = {r.name: r.queue_depth for r in cands}
        if not cands:
            if not healthy:
                raise ApiError(
                    503, "no_replicas",
                    "no healthy replica in the fleet (all ejected); "
                    "retry after the prober readmits one",
                )
            fleet_models = sorted({m for r in healthy for m in r.models})
            raise ApiError(
                404, "unknown_model",
                f"no healthy replica hosts model {model!r} "
                f"(fleet models: {fleet_models})",
            )
        order: List[ReplicaState] = []
        if pinned is not None:
            p = self._by_name.get(pinned)
            if p is None:
                raise ApiError(404, "unknown_replica",
                               f"no replica {pinned!r} in this fleet "
                               f"(replicas: {sorted(self._by_name)})")
            if p in cands:
                order.append(p)
                cands = [r for r in cands if r is not p]
        if len(cands) >= 2:
            a, b = self._rng.sample(cands, 2)
            lo, hi = ((a, b) if depths[a.name] <= depths[b.name] else (b, a))
            order += [lo, hi]
            order += sorted((r for r in cands if r is not a and r is not b),
                            key=lambda r: depths[r.name])
        else:
            order += cands
        return order

    def route_job(self, payload: Dict[str, Any],
                  raw: bytes) -> Tuple[int, Dict[str, Any]]:
        """Place one job: try candidates in order, fail over past full
        (429) and dead (transport / 503 → ejected) replicas, rewrite the
        accepted job id to the router encoding."""
        order = self._placement_order(payload.get("model"),
                                      payload.get("replica"))
        last_full: Optional[Tuple[int, Dict[str, Any]]] = None
        for i, r in enumerate(order):
            if i > 0:
                with self._lock:
                    self._failovers += 1
            try:
                status, body = http_request(
                    f"{r.url}/v1/jobs", "POST", data=raw,
                    timeout=self.request_timeout_s,
                )
            except TransportError as e:
                self._eject(r, f"submit failed: {e}")
                continue
            if status == 202:
                with self._lock:
                    self._jobs_routed += 1
                    self._routed_per_replica[r.name] += 1
                    r.queue_depth += 1  # optimistic, until the next poll
                body["job_id"] = f"{r.name}:{body['job_id']}"
                body["replica"] = r.name
                log_event("router.route", replica=r.name,
                          job_id=body["job_id"], model=body.get("model"),
                          failovers=i)
                return 202, body
            if status == 429:
                # full, not broken: remember the backpressure body and
                # try the next candidate; only all-full surfaces it
                last_full = (status, body)
                continue
            if status == 503:
                # stopped service or open breaker — gone from rotation
                # until the prober readmits it
                self._eject(r, f"503 at submit: {body.get('error')}")
                continue
            return status, body  # 400/404/...: the request's own problem
        if last_full is not None:
            return last_full
        raise ApiError(
            503, "no_replicas",
            "every candidate replica was ejected while placing the job; "
            "retry after the prober readmits one",
        )

    # ------------------------------------------------------------- proxying

    def _parse_rid(self, rid: str) -> Tuple[ReplicaState, str]:
        name, sep, local = rid.partition(":")
        r = self._by_name.get(name)
        if not sep or r is None or not local.lstrip("-").isdigit():
            raise ApiError(
                400, "bad_request",
                f'router job ids look like "r0:123" (replica:local), '
                f"got {rid!r}",
            )
        return r, local

    def job_status(self, rid: str) -> Tuple[int, Dict[str, Any]]:
        """Proxy ``GET /v1/jobs/<id>`` to the owning replica. An ejected
        or unreachable replica answers 503 ``replica_unavailable`` — the
        structured signal that the job is lost from this router and
        should be resubmitted (a survivor will take it)."""
        r, local = self._parse_rid(rid)
        with self._lock:
            healthy = r.healthy
        if not healthy:
            raise ApiError(
                503, "replica_unavailable",
                f"replica {r.name} ({r.url}) is ejected; job {rid} is "
                "unreachable through this router — resubmit it (the "
                "prober readmits the replica when it answers again)",
            )
        try:
            status, body = http_request(f"{r.url}/v1/jobs/{local}",
                                        timeout=self.request_timeout_s)
        except TransportError as e:
            self._eject(r, f"status proxy failed: {e}")
            raise ApiError(
                503, "replica_unavailable",
                f"replica {r.name} ({r.url}) became unreachable while "
                f"polling job {rid} — resubmit it",
            ) from e
        if isinstance(body, dict) and "job_id" in body:
            body["job_id"] = rid
            body["replica"] = r.name
        return status, body

    # -------------------------------------------------------------- readout

    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            health = {r.name: r.healthy for r in self.replicas}
            statuses = {r.name: r.status for r in self.replicas}
            degraded = {r.name: sorted(r.open_breakers)
                        for r in self.replicas if r.status == "degraded"}
        ok = any(health.values())
        status = ("down" if not ok
                  else "degraded" if degraded else "ok")
        return (200 if ok else 503), {
            "ok": ok,
            "status": status,
            "healthy_replicas": sum(health.values()),
            "total_replicas": len(health),
            "replicas": health,
            "replica_status": statuses,
            "degraded": degraded,
        }

    def models(self) -> Dict[str, Any]:
        with self._lock:
            per = {r.name: sorted(r.models) for r in self.replicas
                   if r.healthy}
        return {
            "models": sorted({m for ms in per.values() for m in ms}),
            "replicas": per,
        }

    def stats(self, *, refresh: bool = True) -> Dict[str, Any]:
        """The fleet-wide snapshot: per-replica stats (freshly fetched
        from every healthy replica unless ``refresh=False``), summed
        service counters, merged latency histograms, and the router's own
        placement/failure counters."""
        now = self._clock()
        if refresh:
            for r in self.replicas:
                with self._lock:
                    healthy = r.healthy
                if healthy:
                    self._poll_stats(r, now)
        with self._lock:
            per = {
                r.name: dict(r.snapshot(),
                             stats=r.last_stats if r.healthy else None)
                for r in self.replicas
            }
            live = [r.last_stats for r in self.replicas
                    if r.healthy and r.last_stats]
            fleet: Dict[str, Any] = {
                k: sum(int(s.get(k, 0)) for s in live)
                for k in _SUMMED_COUNTERS
            }
            fleet["jobs_per_batch"] = (
                fleet["jobs_completed"] / fleet["batches"]
                if fleet["batches"] else 0.0
            )
            fleet["models_resident"] = sorted(
                {m for r in self.replicas if r.healthy for m in r.models}
            )
            router = {
                "jobs_routed": self._jobs_routed,
                "routed_per_replica": dict(self._routed_per_replica),
                "failovers": self._failovers,
                "ejections": self._ejections,
                "readmissions": self._readmissions,
                "jobs_unroutable": self._jobs_unroutable,
                "healthy_replicas": sum(r.healthy for r in self.replicas),
                "total_replicas": len(self.replicas),
            }
        telemetry = {
            h: merge_snapshots([s.get("telemetry", {}).get(h) for s in live])
            for h in _HISTOGRAMS
        }
        out = {"router": router, "fleet": fleet, "replicas": per,
               "telemetry": telemetry}
        hook = self.extra_stats
        if hook is not None:
            try:
                out["supervisor"] = hook()
            except Exception as e:  # repro-lint: disable=hygiene-broad-except — user-supplied hook; stats must not die on a hook bug
                out["supervisor"] = {"error": repr(e)}
        return out

    def _count_unroutable(self) -> None:
        with self._lock:
            self._jobs_unroutable += 1


class _RouterHandler(JsonHandler):
    def do_POST(self):
        fe: FleetRouter = self.server.frontend

        def handle():
            if self.path.rstrip("/") != "/v1/jobs":
                raise ApiError(404, "not_found", f"no route POST {self.path!r}")
            payload = self.read_json_body()
            try:
                return fe.route_job(payload, self.raw_body)
            except ApiError as e:
                if e.err_type in ("no_replicas", "unknown_model"):
                    fe._count_unroutable()
                raise

        self._dispatch(handle)

    def do_GET(self):
        fe: FleetRouter = self.server.frontend

        def handle():
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path == "/v1/healthz":
                return fe.healthz()
            if path == "/v1/stats":
                return 200, fe.stats()
            if path == "/v1/models":
                return 200, fe.models()
            if path.startswith("/v1/jobs/"):
                return fe.job_status(path[len("/v1/jobs/"):])
            raise ApiError(404, "not_found", f"no route GET {self.path!r}")

        self._dispatch(handle)


# ---------------------------------------------------------- fleet client

def route_jobs(
    base_url: str,
    payloads: Sequence[Dict[str, Any]],
    *,
    timeout: float = 600.0,
    resubmit_lost: bool = True,
    retry_failed: int = 0,
    poll_s: float = 0.005,
    poll_cap_s: float = 0.25,
) -> List[Dict[str, Any]]:
    """Submit ``payloads`` through a router (or a single replica — the
    wire is identical) and poll every job to a terminal state.

    The client half of the fleet's failure policy:

    - 429 / 503-``no_replicas`` at submit → capped-backoff retry (the
      fleet is full or mid-readmission; backpressure, not failure).
    - a poll answering 503 ``replica_unavailable``, 410 ``evicted`` or
      404 ``unknown_job`` for an *accepted* job (its replica died, was
      restarted, or aged the handle out) → resubmit the payload to the
      router, which places it on a survivor (``resubmit_lost=False``
      records the loss loudly instead). Simulation jobs are idempotent
      pure functions of their payload, so a resubmission changes nothing
      but where the work ran.
    - a `TransportError` talking to the *router* (or an injected
      ``http.request`` chaos fault, which fires before the request is
      sent — never a duplicate) → capped-backoff retry until ``timeout``.
    - ``retry_failed=N``: a job that terminates ``failed`` with a
      ``batch_failed`` error is resubmitted up to N times. The failed
      attempt produced no result, so this cannot duplicate work — it is
      how a chaos drill proves transient faults (injected compile
      failure, watchdogged batch, NaN poisoning) cost retries, not jobs.

    Returns one entry per payload: ``{"id", "job_id", "replica",
    "status", "resubmits"}`` plus ``"result"`` when done or ``"error"``
    when failed/lost."""
    deadline = time.monotonic() + timeout

    def request(url, method="GET", payload=None):
        """http_request with transport-level retries against the router."""
        backoff = Backoff(poll_s, poll_cap_s)
        while True:
            try:
                return http_request(url, method, payload, timeout=timeout)
            except TransportError:
                if time.monotonic() >= deadline:
                    raise
                backoff.sleep()

    def post(payload) -> Tuple[str, Optional[str], Optional[Dict]]:
        backoff = Backoff(poll_s, poll_cap_s)
        while True:
            status, body = request(f"{base_url}/v1/jobs", "POST", payload)
            if status == 202:
                return body["job_id"], body.get("replica"), None
            retryable = status == 429 or (
                status == 503
                and body.get("error", {}).get("type") == "no_replicas"
            )
            if not retryable or time.monotonic() >= deadline:
                return None, None, {"status": status, **body}
            backoff.sleep()

    entries: List[Dict[str, Any]] = []
    for i, payload in enumerate(payloads):
        jid, replica, err = post(payload)
        e = {"id": payload.get("id") or f"job{i}", "job_id": jid,
             "replica": replica, "status": "pending", "resubmits": 0}
        if err is not None:
            e.update(status="failed", error=err)
        entries.append(e)

    for i, e in enumerate(entries):
        if e["status"] != "pending":
            continue
        failed_retries = 0
        backoff = Backoff(poll_s, poll_cap_s)
        while True:
            status, body = request(f"{base_url}/v1/jobs/{e['job_id']}")
            lost = (
                (status == 503
                 and body.get("error", {}).get("type") == "replica_unavailable")
                or status in (404, 410)
            )
            if status == 200 and body.get("status") != "pending":
                err_type = (body.get("error") or {}).get("type")
                if (body.get("status") == "failed"
                        and err_type == "batch_failed"
                        and failed_retries < retry_failed):
                    # the attempt failed terminally — no result exists, so
                    # a fresh submit re-runs, never duplicates, the job
                    jid, replica, err = post(payloads[i])
                    if err is None:
                        failed_retries += 1
                        e.update(job_id=jid, replica=replica)
                        e["resubmits"] += 1
                        backoff.reset()
                        continue
                e["status"] = body["status"]
                e["replica"] = body.get("replica", e["replica"])
                if body["status"] == "done":
                    e["result"] = body["result"]
                else:
                    e["error"] = body.get("error")
                break
            if lost:
                if not resubmit_lost:
                    e.update(status="lost", error={"status": status, **body})
                    break
                jid, replica, err = post(payloads[i])
                if err is not None:
                    e.update(status="failed", error=err)
                    break
                e.update(job_id=jid, replica=replica)
                e["resubmits"] += 1
                backoff.reset()
                continue
            if status != 200:
                e.update(status="failed", error={"status": status, **body})
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {e['job_id']} still pending after {timeout}s")
            backoff.sleep()
    return entries
