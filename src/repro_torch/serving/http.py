"""SimServe over the wire: a stdlib-only HTTP front-end — the port of
``repro.serving.http``. Handler threads do host work only (JSON, numpy,
``submit``); every device operation runs on the service's drain thread.

Real concurrent clients hit the background drain loop over the network —
the deployment shape the paper's throughput claim implies and NeuroScalar
argues for ("in the wild", under SLOs). One `SimServeHTTP` wraps a
(started) `SimServe`; `ThreadingHTTPServer` gives each client its own
handler thread, every request funnels into the same thread-safe
``submit``/handle machinery the in-process clients use, so wire results
are bit-identical to in-process ones.

Endpoints (all JSON):

- ``POST /v1/jobs``        — submit a job, returns ``{"job_id", "status",
  "correlation_id", "model"}``. The body carries either raw trace arrays
  (``"trace": {"feat", "addr", "is_store", "labels"}``) or a benchmark
  spec (``"bench"``/``"n"``/``"o3"`` — the server runs/caches the DES
  trace), plus ``"model"``, ``"lanes"``, ``"id"``, ``"priority"``,
  ``"deadline_ms"``. Errors map to structured bodies: malformed JSON /
  bad trace → 400, unknown model → 404, `QueueFull` → 429, open circuit
  breaker → 503.
- ``GET /v1/jobs/<id>``    — result-or-pending: ``{"status": "pending"}``
  until the job is terminal, then ``done`` (+``"result"``), ``failed``
  (+``"error"``: ``deadline_exceeded`` or ``batch_failed``) or
  ``cancelled``.
- ``GET /v1/stats``        — the service's atomic `stats()` snapshot,
  histograms and breaker states included.
- ``GET /v1/healthz``      — 200 while the drain loop is running, 503
  once ``stop()`` flips it (load balancers eject the instance).
- ``GET /v1/models``       — the resident model ids, ``{"models": [...]}``
  (the fleet router discovers per-replica placement through this).

A handle evicted from the bounded tracking map answers 410 (error type
``"evicted"``) — distinct from 404 for an id this front-end never issued,
so a client that polled too late can tell "gone" from "never existed".

No new dependencies: ``http.server`` + ``json`` + ``urllib`` only.

    serve = SimServe(max_wait_ms=5.0)
    serve.register("c3", "artifacts/models/c3")
    with SimServeHTTP(serve) as front:        # starts serve's loop too
        print(front.url)                      # http://127.0.0.1:<port>
        ...                                   # clients POST /v1/jobs

Shell: ``python -m repro_torch serve --jobs jobs.json --http 0`` round-trips
the job file through a live ephemeral-port server.
"""
from __future__ import annotations

import collections
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.serving.backoff import Backoff
from repro_torch.serving.service import (
    DeadlineExceeded,
    JobHandle,
    ModelUnavailable,
    QueueFull,
    SimServe,
)
from repro_torch.serving.telemetry import log_event


class ApiError(Exception):
    """An HTTP-mappable request failure with a structured JSON body."""

    def __init__(self, status: int, err_type: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.err_type = err_type

    def body(self) -> Dict[str, Any]:
        return {"error": {"type": self.err_type, "message": str(self)}}


class TransportError(RuntimeError):
    """The request never produced an HTTP response: connection refused,
    reset mid-read, timeout, DNS failure.

    Distinct from an HTTP error *status* (those return normally with the
    structured body — the server answered). The router's failover logic
    branches on exactly this: a `TransportError` means the replica is
    unreachable (eject it, try another), while a 4xx/5xx body is the
    replica speaking policy. Callers that used to leak raw ``URLError``
    internals now get one typed, catchable failure."""

    def __init__(self, url: str, cause: BaseException):
        super().__init__(f"{url}: {cause!r}")
        self.url = url
        self.cause = cause


def _trace_from_wire(spec) -> Dict[str, np.ndarray]:
    """Rebuild a trace-arrays dict from JSON lists. float32/int32 survive
    the float64 JSON round-trip exactly, so totals stay bit-identical to
    an in-process submit of the same arrays."""
    from repro_torch.core import features as F

    if not isinstance(spec, dict):
        raise ApiError(400, "bad_trace", '"trace" must be an object of arrays')
    try:
        arrs = {
            "feat": np.asarray(spec["feat"], dtype=np.float32),
            "addr": np.asarray(spec["addr"], dtype=np.int32),
            "is_store": np.asarray(spec["is_store"], dtype=bool),
            "labels": np.asarray(spec["labels"], dtype=np.float32),
        }
    except KeyError as e:
        raise ApiError(400, "bad_trace", f'"trace" is missing key {e}') from None
    except (TypeError, ValueError, OverflowError) as e:
        raise ApiError(400, "bad_trace", f"un-arrayable trace field: {e}") from None
    T = arrs["feat"].shape[0] if arrs["feat"].ndim == 2 else -1
    if (arrs["feat"].ndim != 2 or arrs["feat"].shape[1] != F.STATIC_END
            or arrs["addr"].shape != (T, F.N_ADDR_KEYS)
            or arrs["is_store"].shape != (T,)
            or arrs["labels"].shape != (T, 3)):
        raise ApiError(
            400, "bad_trace",
            f"trace shapes must be feat (T, {F.STATIC_END}), addr "
            f"(T, {F.N_ADDR_KEYS}), is_store (T,), labels (T, 3); got "
            + str({k: list(v.shape) for k, v in arrs.items()}),
        )
    return arrs


class SimServeHTTP:
    """The wire front-end over one `SimServe`.

    ``start()`` binds (port 0 = ephemeral), force-starts the service's
    background drain loop (HTTP clients cannot drain inline) unless
    ``start_service=False``, and serves on a daemon thread; returns the
    bound port. Handles are tracked per job id so ``GET /v1/jobs/<id>``
    can answer result-or-pending; the map is bounded (oldest evicted) —
    a resident front-end must not grow without bound."""

    def __init__(self, service: SimServe, host: str = "127.0.0.1",
                 port: int = 0, *, cache_dir: Optional[str] = None,
                 start_service: bool = True, max_tracked_jobs: int = 4096):
        self.service = service
        self.host = host
        self.port = int(port)  # rebound to the real port by start()
        self.cache_dir = cache_dir
        self.start_service = start_service
        self.max_tracked_jobs = int(max_tracked_jobs)
        self._handles: "collections.OrderedDict[int, JobHandle]" = (
            collections.OrderedDict()
        )
        # ids evicted from the bounded map, so GET can answer 410 "evicted"
        # instead of a (wrong) 404 "never existed"; itself bounded — ints
        # are cheap, so the memory of evictions outlives the handles 16×
        self._evicted: "collections.deque[int]" = collections.deque(
            maxlen=max(16 * self.max_tracked_jobs, 1)
        )
        self._evicted_set: set = set()
        self._hlock = threading.Lock()
        self._traces: Dict[Tuple, Any] = {}  # (bench, n, o3) -> arrays
        self._tlock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        if self.start_service and not self.service.running:
            self.service.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.frontend = self  # the handler reaches back through this
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="simserve-http", daemon=True
        )
        self._thread.start()
        log_event("http.start", level=logging.INFO, host=self.host,
                  port=self.port)
        return self.port

    def stop(self, *, stop_service: bool = False) -> None:
        """Shut the listener down (in-flight handlers finish). The
        underlying service keeps running unless ``stop_service``."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        if stop_service:
            self.service.stop()
        log_event("http.stop", level=logging.INFO, host=self.host,
                  port=self.port)

    def __enter__(self) -> "SimServeHTTP":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------- request logic

    def _bench_trace(self, payload: Dict[str, Any]):
        """Server-side DES trace for a {"bench", "n", "o3"} job spec,
        memoized so repeated jobs share one reference simulation."""
        from repro_torch.core import api
        from repro_torch.des.o3 import A64FX_CONFIG

        bench = payload["bench"]
        n = int(payload.get("n", 10000))
        o3 = payload.get("o3", "default")
        key = (bench, n, o3)
        with self._tlock:
            if key not in self._traces:
                cfg = {"default": None, "a64fx": A64FX_CONFIG}.get(o3)
                if o3 not in ("default", "a64fx"):
                    raise ApiError(400, "bad_request", f"unknown o3 {o3!r}")
                try:
                    tr = api.generate_traces(
                        [bench], n, o3=cfg, cache_dir=self.cache_dir
                    )[0]
                except KeyError as e:
                    raise ApiError(400, "unknown_bench", str(e)) from None
                self._traces[key] = tr
            return self._traces[key]

    def submit_job(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "trace" in payload:
            trace = _trace_from_wire(payload["trace"])
        elif "bench" in payload:
            trace = self._bench_trace(payload)
        else:
            raise ApiError(400, "bad_request",
                           'a job needs either "trace" (raw arrays) or '
                           '"bench" (server-side DES trace)')
        try:
            h = self.service.submit(
                trace,
                payload.get("model"),
                n_lanes=int(payload.get("lanes", 8)),
                name=payload.get("id") or None,
                priority=int(payload.get("priority", 0)),
                deadline_ms=payload.get("deadline_ms"),
            )
        except QueueFull as e:
            raise ApiError(429, "queue_full", str(e)) from None
        except ModelUnavailable as e:
            raise ApiError(503, "model_unavailable", str(e)) from None
        except KeyError as e:
            raise ApiError(404, "unknown_model", str(e.args[0])) from None
        except (TypeError, ValueError) as e:
            raise ApiError(400, "bad_request", str(e)) from None
        with self._hlock:
            self._handles[h.job_id] = h
            while len(self._handles) > self.max_tracked_jobs:
                old_id, _ = self._handles.popitem(last=False)
                if len(self._evicted) == self._evicted.maxlen:
                    self._evicted_set.discard(self._evicted[0])
                self._evicted.append(old_id)
                self._evicted_set.add(old_id)
        return {"job_id": h.job_id, "status": "pending",
                "model": h.model_id, "correlation_id": h.correlation_id}

    def job_status(self, job_id: int) -> Dict[str, Any]:
        with self._hlock:
            h = self._handles.get(job_id)
            evicted = h is None and job_id in self._evicted_set
        if evicted:
            raise ApiError(
                410, "evicted",
                f"job {job_id} was tracked but evicted from the bounded "
                f"handle map (max_tracked_jobs={self.max_tracked_jobs}); "
                "its result is gone from this front-end — resubmit"
            )
        if h is None:
            raise ApiError(404, "unknown_job",
                           f"no tracked job {job_id} on this front-end")
        out: Dict[str, Any] = {"job_id": job_id, "model": h.model_id,
                               "correlation_id": h.correlation_id}
        job = h._job
        if not h.done():
            out["status"] = "pending"
        elif job.cancelled:
            out["status"] = "cancelled"
        elif job.error is not None:
            kind = ("deadline_exceeded" if isinstance(job.error, DeadlineExceeded)
                    else "batch_failed")
            out["status"] = "failed"
            out["error"] = {"type": kind, "message": str(job.error)}
        else:
            out["status"] = "done"
            out["result"] = job.result.to_dict()
        return out


class JsonHandler(BaseHTTPRequestHandler):
    """Shared request plumbing for every serving-tier HTTP surface (the
    replica front-end here, the fleet router in `repro_torch.serving.router`):
    structured JSON in, structured JSON out, `ApiError` → its status +
    body, anything else → a 500 with a structured body — a silent hangup
    would strand the client."""

    server_version = "SimServe/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # stderr noise -> structured log
        log_event("http.access", client=self.address_string(),
                  line=fmt % args)

    def _send(self, status: int, obj) -> None:
        body = json.dumps(obj, default=float).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, fn) -> None:
        try:
            status, obj = fn()
            self._send(status, obj)
        except ApiError as e:
            self._send(e.status, e.body())
        except BrokenPipeError:  # client went away mid-response
            pass
        # HTTP boundary: any unhandled bug must become a 500 for THIS
        # client, never a dead connection or a dead server thread
        except Exception as e:  # pragma: no cover - defensive  # repro-lint: disable=hygiene-broad-except — boundary turns any bug into a logged 500
            log_event("http.error", level=logging.ERROR, path=self.path,
                      error=repr(e))
            self._send(500, {"error": {"type": "internal", "message": repr(e)}})

    def read_json_body(self) -> Dict[str, Any]:
        """The request body as a JSON object (400 on anything else). The
        raw bytes stay on ``self.raw_body`` so a proxying handler can
        forward them without re-encoding."""
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.raw_body = self.rfile.read(length)
        try:
            payload = json.loads(raw if raw else b"")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            raise ApiError(400, "malformed_json", str(e)) from None
        if not isinstance(payload, dict):
            raise ApiError(400, "malformed_json",
                           "the job body must be a JSON object")
        return payload


class _Handler(JsonHandler):
    def do_POST(self):
        fe = self.server.frontend

        def handle():
            if self.path.rstrip("/") != "/v1/jobs":
                raise ApiError(404, "not_found", f"no route POST {self.path!r}")
            return 202, fe.submit_job(self.read_json_body())

        self._dispatch(handle)

    def do_GET(self):
        fe = self.server.frontend

        def handle():
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path == "/v1/healthz":
                running = fe.service.running
                # degraded: serving, but at least one model's breaker is
                # open (isolated artifact). 200 on purpose — a load
                # balancer must not eject a replica that still serves its
                # healthy residents; the router surfaces the detail.
                open_breakers = sorted(
                    mid for mid, snap in
                    fe.service.registry.breaker_snapshots().items()
                    if snap["state"] == "open"
                )
                status = ("down" if not running
                          else "degraded" if open_breakers else "ok")
                return (200 if running else 503), {
                    "ok": running,
                    "status": status,
                    "open_breakers": open_breakers,
                    "running": running,
                    "models_resident": sorted(fe.service.registry.ids()),
                }
            if path == "/v1/stats":
                return 200, fe.service.stats()
            if path == "/v1/models":
                # the router's discovery endpoint: which residents can this
                # replica serve (placement is model-aware)
                return 200, {"models": sorted(fe.service.registry.ids())}
            if path.startswith("/v1/jobs/"):
                tail = path.rsplit("/", 1)[1]
                try:
                    jid = int(tail)
                except ValueError:
                    raise ApiError(400, "bad_request",
                                   f"job id must be an integer, got {tail!r}"
                                   ) from None
                return 200, fe.job_status(jid)
            raise ApiError(404, "not_found", f"no route GET {self.path!r}")

        self._dispatch(handle)


# -------------------------------------------------------------- thin client

def http_request(url: str, method: str = "GET", payload=None,
                 timeout: float = 60.0, *,
                 data: Optional[bytes] = None) -> Tuple[int, Dict[str, Any]]:
    """One JSON request; returns (status, body) and never raises on HTTP
    error statuses — the structured error body is the point.

    Transport-level failures (connection refused, reset mid-read,
    timeout) raise `TransportError` instead of leaking raw ``URLError``
    internals: the server never answered, so there is no status to
    return — and the router's failover branches on exactly this type.

    ``data`` sends pre-encoded body bytes verbatim (the router forwards
    client payloads without a decode → re-encode round trip); it is
    mutually exclusive with ``payload``."""
    import http.client
    import urllib.error
    import urllib.request

    # Chaos seam: an injected transport fault fires BEFORE the request is
    # sent, so a failed send provably never reached the server — retrying
    # a faulted POST cannot duplicate the job.
    from repro_torch.serving import faults

    try:
        faults.fire("http.request")
    except faults.FaultInjected as e:
        raise TransportError(url, e) from e

    if data is None and payload is not None:
        data = json.dumps(payload, default=float).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read() or b"{}")
    except (OSError, http.client.HTTPException) as e:
        # URLError (itself an OSError), ConnectionError, socket.timeout,
        # IncompleteRead/RemoteDisconnected: one typed failure
        raise TransportError(url, e) from e


def wait_job(base_url: str, job_id, *, timeout: float = 600.0,
             poll_s: float = 0.005, poll_cap_s: float = 0.25) -> Dict[str, Any]:
    """Poll ``GET /v1/jobs/<id>`` until the job leaves "pending".

    Polls with capped exponential backoff (``poll_s`` doubling up to
    ``poll_cap_s``): snappy for short jobs, bounded request rate for long
    ones — at fleet scale, N clients × fixed-interval polls would hammer
    the router."""
    deadline = time.monotonic() + timeout
    backoff = Backoff(poll_s, max(poll_cap_s, poll_s))
    while True:
        status, body = http_request(f"{base_url}/v1/jobs/{job_id}")
        if status != 200:
            raise RuntimeError(f"job {job_id} poll failed: {status} {body}")
        if body.get("status") != "pending":
            return body
        if time.monotonic() >= deadline:
            raise TimeoutError(f"job {job_id} still pending after {timeout}s")
        backoff.sleep()
