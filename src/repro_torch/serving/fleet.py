"""Fleet process management: N SimServe replicas + one router, one call —
the port of ``repro.serving.fleet``.

`repro_torch.serving.router.FleetRouter` balances over replicas that
already exist; this module makes them exist. Each replica is a real
subprocess running ``python -m repro_torch serve --http 0 --device <dev>``
(the CLI's standing server mode): its own interpreter, its own registry
and drain loop, its own program cache (and, on the card, its own CUDA
context and graphs) — the process isolation that makes the fleet scale
past one GIL and one host's memory for the zoo, and that lets a replica
be killed and restarted without touching its peers. The fleet's
``device`` (default ``cuda``) is handed to every replica; a replica never
picks one of its own, and one that finds no GPU exits non-zero, which
`ReplicaSpawnError` reports.

    with Fleet(2, models={"c3": "artifacts/models/c3"}) as fleet:
        print(fleet.url)                  # the router's /v1/* surface
        ...                               # clients POST /v1/jobs
        fleet.kill_replica(0)             # failure drill: router ejects it
        fleet.restart_replica(0)          # same port; prober readmits it

Startup protocol: every replica binds an ephemeral port and prints one
JSON line ``{"event": "listening", "port": N, ...}`` on stdout; the
fleet spawns all replicas first (the heavy interpreter + torch import runs
in parallel across them), then collects the ports, then starts the
router over the collected URLs. Any replica failing to come up tears the
whole fleet down — no orphan subprocesses — with that replica's stderr
tail in the raised error.

Shell entry: ``python -m repro_torch fleet --replicas N --jobs jobs.json``.
"""
from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch._device import DEVICE_KINDS
from repro_torch.serving import faults
from repro_torch.serving.backoff import Backoff
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.telemetry import log_event
import logging


def _repro_env() -> Dict[str, str]:
    """The child environment: whatever we run under, plus the repro_torch
    package's parent on PYTHONPATH so ``-m repro_torch`` resolves in the
    child exactly as it did here (editable/src checkouts included)."""
    import repro_torch

    # namespace-package safe: __file__ may be None, __path__ isn't
    pkg_dir = (Path(repro_torch.__file__).parent if repro_torch.__file__
               else Path(next(iter(repro_torch.__path__))))
    src = str(pkg_dir.resolve().parent)
    env = dict(os.environ)
    existing = env.get("PYTHONPATH", "")
    if src not in existing.split(os.pathsep):
        env["PYTHONPATH"] = src + (os.pathsep + existing if existing else "")
    return env


class ReplicaSpawnError(RuntimeError):
    """A replica subprocess died or never announced its port."""


class ReplicaProcess:
    """One SimServe replica subprocess.

    ``spawn()`` launches it; ``wait_listening()`` blocks until the child
    prints its ``{"event": "listening", "port": N}`` line (or raises
    `ReplicaSpawnError` with the child's stderr tail and reaps it).
    stderr goes to a log file, not a pipe — an undrained pipe would
    eventually block the child on its own logging."""

    def __init__(
        self,
        name: str,
        *,
        models: Optional[Dict[str, str]] = None,
        port: int = 0,
        max_queue_depth: int = 0,
        max_wait_ms: float = 5.0,
        chunk: int = 1024,
        cache_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        cmd: Optional[Sequence[str]] = None,
        stop_grace_s: float = 10.0,
        batch_timeout_s: float = 0.0,
        faults_spec: Optional[str] = None,
        device: str = "cuda",
    ):
        if device not in DEVICE_KINDS:
            raise ValueError(f"device must be one of {DEVICE_KINDS}, got {device!r}")
        self.name = name
        self.device = device
        self.models = dict(models or {})
        self.port = int(port)  # 0 until wait_listening() learns the real one
        self.max_queue_depth = int(max_queue_depth)
        self.max_wait_ms = float(max_wait_ms)
        self.chunk = int(chunk)
        self.cache_dir = cache_dir
        # SIGTERM → this much grace to flush telemetry/logs → SIGKILL
        self.stop_grace_s = float(stop_grace_s)
        self.batch_timeout_s = float(batch_timeout_s)
        # a chaos plan for the *replica process* (its own seed/site specs,
        # installed by the child's CLI entry — independent of any plan in
        # this driver process)
        self.faults_spec = faults_spec
        self._log_dir = log_dir or tempfile.mkdtemp(prefix="repro-fleet-")
        self.stderr_path = Path(self._log_dir) / f"{self.name}.stderr.log"
        self._cmd_override = list(cmd) if cmd is not None else None
        self._proc: Optional[subprocess.Popen] = None
        self._stderr_f = None

    def command(self) -> List[str]:
        if self._cmd_override is not None:
            return self._cmd_override
        cmd = [sys.executable, "-u", "-m", "repro_torch", "serve",
               "--http", str(self.port), "--device", self.device,
               "--max-queue-depth", str(self.max_queue_depth),
               "--max-wait-ms", str(self.max_wait_ms),
               "--chunk", str(self.chunk)]
        if self.batch_timeout_s > 0:
            cmd += ["--batch-timeout-s", str(self.batch_timeout_s)]
        if self.faults_spec:
            cmd += ["--faults", self.faults_spec]
        for mid, path in sorted(self.models.items()):
            cmd += ["--model", f"{mid}={path}"]
        if self.cache_dir:
            # per-replica trace-cache subdir: two replicas racing one npz
            # write could tear the file
            cmd += ["--cache-dir", str(Path(self.cache_dir) / self.name)]
        return cmd

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def spawn(self) -> "ReplicaProcess":
        if self.alive:
            return self
        self._stderr_f = open(self.stderr_path, "ab")
        # bufsize=0: stdout is the raw pipe, so select() readiness and
        # read() agree (a Python-side buffer would hide ready bytes)
        self._proc = subprocess.Popen(
            self.command(), stdout=subprocess.PIPE, stderr=self._stderr_f,
            stdin=subprocess.DEVNULL, env=_repro_env(), bufsize=0,
        )
        log_event("fleet.spawn", level=logging.INFO, replica=self.name,
                  pid=self._proc.pid, cmd=self.command())
        return self

    def _stderr_tail(self, n: int = 30) -> str:
        try:
            lines = self.stderr_path.read_text(errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "<no stderr captured>"

    def wait_listening(self, timeout_s: float = 180.0) -> int:
        """Block until the child announces its port; returns it."""
        assert self._proc is not None, "spawn() first"
        out = self._proc.stdout
        deadline = time.monotonic() + timeout_s
        buf = b""
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise ReplicaSpawnError(
                    f"replica {self.name} exited rc={self._proc.returncode} "
                    f"before listening; stderr tail:\n{self._stderr_tail()}"
                )
            ready, _, _ = select.select([out], [], [], 0.2)
            if not ready:
                continue
            chunk = out.read(65536)
            if not chunk:
                continue  # EOF races the poll() above; loop and re-check
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                try:
                    msg = json.loads(line)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue  # stray stdout noise (library banners etc.)
                if isinstance(msg, dict) and msg.get("event") == "listening":
                    self.port = int(msg["port"])
                    return self.port
        self.stop(timeout_s=5.0)
        raise ReplicaSpawnError(
            f"replica {self.name} did not announce a port within "
            f"{timeout_s}s; stderr tail:\n{self._stderr_tail()}"
        )

    def kill(self) -> None:
        """Hard SIGKILL — the failure-drill path (connection refused for
        every in-flight and future request)."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._close_files()

    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Graceful teardown: SIGTERM, wait up to ``stop_grace_s`` (the
        CLI's standing server traps SIGTERM and flushes its final stats),
        then SIGKILL. ``timeout_s`` overrides the grace for this call."""
        grace = self.stop_grace_s if timeout_s is None else float(timeout_s)
        p = self._proc
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                log_event("fleet.stop_forced", level=logging.WARNING,
                          replica=self.name, grace_s=grace)
                p.kill()
                p.wait()
        self._close_files()

    def _close_files(self) -> None:
        if self._proc is not None and self._proc.stdout is not None:
            self._proc.stdout.close()
        if self._stderr_f is not None:
            self._stderr_f.close()
            self._stderr_f = None

    def __repr__(self):
        state = ("alive" if self.alive else "dead")
        return f"ReplicaProcess({self.name!r}, port={self.port}, {state})"


class Fleet:
    """N replica subprocesses + the router over them.

    One zoo spec (``models``: id → artifact dir) is given to *every*
    replica, so any replica can serve any model and the router's
    model-aware placement degenerates to pure load balancing; pass
    ``models_per_replica`` instead to shard the zoo (the seed of the
    too-big-for-one-host deployment)."""

    def __init__(
        self,
        n_replicas: int,
        models: Optional[Dict[str, str]] = None,
        *,
        models_per_replica: Optional[Sequence[Dict[str, str]]] = None,
        router_port: int = 0,
        max_queue_depth: int = 0,
        max_wait_ms: float = 5.0,
        chunk: int = 1024,
        cache_dir: Optional[str] = None,
        startup_timeout_s: float = 180.0,
        poll_interval_s: float = 0.25,
        probe_initial_s: float = 0.05,
        probe_cap_s: float = 2.0,
        stop_grace_s: float = 10.0,
        batch_timeout_s: float = 0.0,
        replica_faults: Optional[str] = None,
        supervise: bool = False,
        restart_budget: int = 3,
        restart_backoff_initial_s: float = 0.25,
        restart_backoff_cap_s: float = 5.0,
        supervise_interval_s: float = 0.2,
        device: str = "cuda",
    ):
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if models_per_replica is not None and len(models_per_replica) != n_replicas:
            raise ValueError(
                f"models_per_replica has {len(models_per_replica)} entries "
                f"for {n_replicas} replicas"
            )
        self.startup_timeout_s = float(startup_timeout_s)
        self.router_port = int(router_port)
        self._router_kw = dict(
            poll_interval_s=poll_interval_s,
            probe_initial_s=probe_initial_s, probe_cap_s=probe_cap_s,
        )
        log_dir = tempfile.mkdtemp(prefix="repro-fleet-")
        self.replicas = [
            ReplicaProcess(
                f"r{i}",
                models=(models_per_replica[i] if models_per_replica is not None
                        else models),
                max_queue_depth=max_queue_depth, max_wait_ms=max_wait_ms,
                chunk=chunk, cache_dir=cache_dir, log_dir=log_dir,
                stop_grace_s=stop_grace_s, batch_timeout_s=batch_timeout_s,
                faults_spec=replica_faults, device=device,
            )
            for i in range(n_replicas)
        ]
        self.router: Optional[FleetRouter] = None
        # -- supervision: detect dead replicas, restart under a capped
        # budget with backoff pacing (off by default: failure drills that
        # hand-kill replicas expect them to STAY dead)
        self.supervise = bool(supervise)
        self.restart_budget = int(restart_budget)
        self.supervise_interval_s = float(supervise_interval_s)
        self._sup_backoff_kw = dict(
            initial_s=restart_backoff_initial_s,
            cap_s=max(restart_backoff_cap_s, restart_backoff_initial_s),
        )
        self._sup_lock = threading.Lock()
        self._sup_thread: Optional[threading.Thread] = None
        self._sup_stop = threading.Event()
        self._restarts: Dict[str, int] = {r.name: 0 for r in self.replicas}
        self._restart_failures = 0
        self._chaos_kills = 0
        self._sup_backoff: Dict[str, Backoff] = {}
        self._sup_next_t: Dict[str, float] = {}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Fleet":
        if self.router is not None:
            return self
        try:
            for r in self.replicas:
                r.spawn()  # all interpreters boot in parallel...
            deadline = time.monotonic() + self.startup_timeout_s
            for r in self.replicas:  # ...then collect the ports
                r.wait_listening(max(deadline - time.monotonic(), 1.0))
            self.router = FleetRouter(
                [r.url for r in self.replicas], port=self.router_port,
                **self._router_kw,
            )
            self.router.extra_stats = self.supervisor_stats
            self.router.start()
            if self.supervise:
                self._sup_stop = threading.Event()
                self._sup_thread = threading.Thread(
                    target=self._supervisor_loop, name="fleet-supervisor",
                    daemon=True,
                )
                self._sup_thread.start()
        except BaseException:
            self.stop()  # no orphan subprocesses, ever
            raise
        log_event("fleet.start", level=logging.INFO,
                  replicas={r.name: r.url for r in self.replicas},
                  router=self.router.url)
        return self

    def stop(self) -> None:
        # supervisor first: teardown must not race a resurrection
        self._sup_stop.set()
        t, self._sup_thread = self._sup_thread, None
        if t is not None:
            t.join(timeout=30)
        router, self.router = self.router, None
        if router is not None:
            router.stop()
        for r in self.replicas:
            r.stop()

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # -------------------------------------------------------- failure drill

    def kill_replica(self, i: int) -> ReplicaProcess:
        """SIGKILL replica ``i`` (the router will eject it on its next
        touch). Returns the dead replica."""
        r = self.replicas[i]
        r.kill()
        log_event("fleet.kill", level=logging.WARNING, replica=r.name)
        return r

    def restart_replica(self, i: int, timeout_s: Optional[float] = None) -> ReplicaProcess:
        """Respawn a dead replica on its ORIGINAL port — the router's
        replica URLs are fixed, so readmission needs the address back."""
        r = self.replicas[i]
        if r.alive:
            return r
        r.spawn()
        r.wait_listening(timeout_s or self.startup_timeout_s)
        log_event("fleet.restart", level=logging.WARNING, replica=r.name,
                  port=r.port)
        return r

    # ----------------------------------------------------------- supervision

    def _supervisor_loop(self) -> None:
        """Detect dead replica processes and restart them on their
        original ports — paced by per-replica exponential backoff (after
        *every* attempt, so a crash-looping replica cannot hot-loop) and
        capped by ``restart_budget`` per replica (a budget-exhausted
        replica stays down, loudly visible in ``supervisor_stats()``).

        Also the ``replica.crash`` chaos site: one arrival per tick; a
        failure decision SIGKILLs a deterministically chosen victim, which
        this same loop then detects and heals — the drill that proves
        crash → restart → readmission end to end."""
        while not self._sup_stop.wait(self.supervise_interval_s):
            try:
                faults.fire("replica.crash")
            except faults.FaultInjected as e:
                victim = self.replicas[e.arrival % len(self.replicas)]
                if victim.alive:
                    victim.kill()
                    with self._sup_lock:
                        self._chaos_kills += 1
                    log_event("fleet.chaos_kill", level=logging.WARNING,
                              replica=victim.name, arrival=e.arrival)
            now = time.monotonic()
            for i, r in enumerate(self.replicas):
                if self._sup_stop.is_set():
                    return
                if r.alive:
                    continue
                with self._sup_lock:
                    if self._restarts[r.name] >= self.restart_budget:
                        continue
                    bo = self._sup_backoff.setdefault(
                        r.name, Backoff(**self._sup_backoff_kw)
                    )
                    if now < self._sup_next_t.get(r.name, 0.0):
                        continue
                    self._sup_next_t[r.name] = now + bo.next()
                if self._sup_stop.is_set():  # teardown owns the replicas now
                    return
                try:
                    self.restart_replica(i)
                except (ReplicaSpawnError, OSError) as e:
                    with self._sup_lock:
                        self._restart_failures += 1
                    log_event("fleet.restart_failed", level=logging.ERROR,
                              replica=r.name, error=repr(e))
                else:
                    with self._sup_lock:
                        self._restarts[r.name] += 1
                    log_event("fleet.supervised_restart",
                              level=logging.WARNING, replica=r.name,
                              port=r.port,
                              restarts=self._restarts[r.name])

    def supervisor_stats(self) -> Dict[str, Any]:
        """Restart counters, merged into the router's ``/v1/stats`` as
        the ``supervisor`` section (via `FleetRouter.extra_stats`)."""
        with self._sup_lock:
            return {
                "enabled": self.supervise,
                "restart_budget": self.restart_budget,
                "restarts": dict(self._restarts),
                "restarts_total": sum(self._restarts.values()),
                "restart_failures": self._restart_failures,
                "chaos_kills": self._chaos_kills,
                "replicas_alive": sum(r.alive for r in self.replicas),
            }

    # -------------------------------------------------------------- readout

    @property
    def url(self) -> str:
        assert self.router is not None, "start() the fleet first"
        return self.router.url

    def stats(self) -> Dict[str, Any]:
        assert self.router is not None, "start() the fleet first"
        return self.router.stats()
