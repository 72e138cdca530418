"""The `SimNet` session and the training loop behind it — the port of
``repro.core.session``.

The paper's deployment model (train-once / simulate-everywhere) as an API:
a session owns a trained latency predictor (or runs teacher-forced without
one) and routes EVERY simulation — single workload, multi-workload pack,
design-space sweep — through the resident `serving.service.SimServe`
path: single-session use is just a service with one client. The session's
predictor is a resident model in a (private or shared) service, jobs pack
into shared lane batches, and the chunk programs (CUDA graphs on the card)
come from the device's program cache, so a second session around a
same-architecture model builds nothing.

    sn = SimNet.train(data, PredictorConfig(kind="c3"))   # or .from_artifact
    sn.save("artifacts/models/c3")                        # PredictorArtifact
    res   = sn.simulate(trace, n_lanes=64)                # SimResult, 1 workload
    res   = sn.simulate_many(traces, n_lanes=8)           # SimResult, packed
    swept = sn.sweep({"256kB": tr0, "4MB": tr1})          # SweepResult

Everything runs on the session's ``device`` (default ``cuda``): the
dataset, the trainer, the engine and its service. Training runs the
unfused predictor (`core.predictor.apply_raw`, plain PyTorch) under
autograd, as the reference trains its unfused predictor: the
hand-written kernels have no backward.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint.artifact import PredictorArtifact
from repro_torch.core.dataset import build_dataset
from repro_torch.core.predictor import (
    REG_SCALE,
    PredictorConfig,
    apply_raw,
    decode_latency,
    init_predictor,
    split_heads,
)
from repro_torch.core.results import SimResult, SweepResult, TrainResult
from repro_torch.core.simulator import SimConfig
from repro_torch.serving.service import SimServe
from repro_torch.serving.simnet_engine import SimNetEngine
from repro_torch.training.optimizer import AdamConfig, adam_init, adam_update

TraceLike = Any  # des.trace.Trace or a raw trace_arrays dict


def _hybrid_loss(raw, y, pcfg: PredictorConfig):
    """Per-head hybrid CE+MSE (paper §2.4: CE for classification output,
    squared error for regression). Regression in REG_SCALE space keeps the
    two terms comparable (raw-cycle MSE would swamp the CE)."""
    cls_logits, reg = split_heads(raw, pcfg)
    y = y.to(torch.float32)
    se = torch.mean(torch.square(reg - y * REG_SCALE))
    if cls_logits is None:
        return se
    n_cls = pcfg.n_classes
    t_int = torch.clamp(y, min=0).to(torch.int64)  # truncation, as astype(int32)
    target = torch.clamp(t_int, max=n_cls - 1)  # overflow -> the last class
    logp = torch.log_softmax(cls_logits.to(torch.float32), dim=-1)
    onehot = torch.nn.functional.one_hot(target, n_cls).to(torch.float32)
    ce = -torch.mean(torch.sum(logp * onehot, dim=-1))
    return ce + se


def _loss(params, x, y, pcfg: PredictorConfig):
    return _hybrid_loss(apply_raw(params, x, pcfg), y, pcfg)


def train_loop(
    data: Dict[str, np.ndarray],
    pcfg: PredictorConfig,
    *,
    epochs: int = 10,
    batch_size: int = 512,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 0,
    device: DeviceLike = None,
) -> tuple:
    """Adam training of a latency predictor on ``device`` (default
    ``cuda``). Returns (params, history); params are the
    best-validation-loss snapshot.

    ``history`` holds the reference's per-epoch ``train_loss`` and
    ``val_loss``, and ``step_loss`` (every step's loss) and
    ``step_seconds`` (each epoch's training steps, waited for on the
    device). The datasets go to the device once (X as float16, as it is
    stored); each batch is gathered there in the reference's order
    (`np.random.default_rng(seed)`, one permutation an epoch)."""
    dev = resolve_device(device)
    params = init_predictor(torch.Generator().manual_seed(seed), pcfg, dev)
    acfg = AdamConfig(lr=lr, clip_norm=1.0)
    opt = adam_init(params)

    def step(p, opt, x, y):
        p = tree_map(lambda t: t.requires_grad_(True), p)
        with torch.enable_grad():
            loss = _loss(p, x, y, pcfg)
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(p))))
        p, opt, _ = adam_update(tree_map(lambda t: next(grads), p), opt, p, acfg)
        return p, opt, loss.detach()

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    X, Y = to_dev(data["train_x"]), to_dev(data["train_y"])
    VX, VY = to_dev(data["val_x"]), to_dev(data["val_y"])
    n = len(X)
    rng = np.random.default_rng(seed)
    history = {"train_loss": [], "val_loss": [], "step_loss": [], "step_seconds": []}
    best = (np.inf, params)
    for ep in range(epochs):
        perm = to_dev(rng.permutation(n))
        losses = []
        t0 = time.perf_counter()
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = perm[lo : lo + batch_size]
            params, opt, l = step(params, opt, X[idx].to(torch.float32), Y[idx])
            losses.append(l)
        losses = torch.stack(losses).tolist() if losses else []  # waits for the device
        history["step_seconds"].append(time.perf_counter() - t0)
        vl = []
        with torch.no_grad():
            for lo in range(0, len(VX) - batch_size + 1, batch_size):
                vl.append(_loss(params, VX[lo : lo + batch_size].to(torch.float32),
                                VY[lo : lo + batch_size], pcfg))
        vl = torch.stack(vl).tolist() if vl else []
        tl, vloss = float(np.mean(losses)), float(np.mean(vl)) if vl else float("nan")
        history["step_loss"] += losses
        history["train_loss"].append(tl)
        history["val_loss"].append(vloss)
        if vloss < best[0]:
            best = (vloss, tree_map(lambda t: t.detach().clone(), params))
        if log_every and (ep % log_every == 0):
            print(f"  epoch {ep}: train {tl:.4f} val {vloss:.4f}")
    # no val batches (dataset smaller than one batch): the nan val loss
    # never beats inf — return the final params, not the initial snapshot
    return best[1] if best[0] < np.inf else params, history


@torch.no_grad()
def prediction_errors(params, pcfg: PredictorConfig, X, Y, batch_size: int = 1024):
    """Paper's per-latency-type error: E = |pred - y| / (y + 1), averaged.
    Runs on the device the params are on."""
    dev = next(tree_leaves(params)).device
    errs = []
    for lo in range(0, len(X), batch_size):
        x = torch.from_numpy(np.asarray(X[lo : lo + batch_size], np.float32)).to(dev)
        y = Y[lo : lo + batch_size]
        p = decode_latency(apply_raw(params, x, pcfg), pcfg).cpu().numpy()
        errs.append(np.abs(p - y) / (y + 1.0))
    e = np.concatenate(errs)
    return {"fetch": float(e[:, 0].mean()), "execution": float(e[:, 1].mean()),
            "store": float(e[:, 2].mean())}


# ---------------------------------------------------------------------------
# session facade
# ---------------------------------------------------------------------------

class SimNet:
    """A simulation session around one predictor (or teacher forcing).

    Construction:
      SimNet(artifact)                       reuse a loaded PredictorArtifact
      SimNet(params=..., pcfg=...)           in-memory predictor
      SimNet()                               teacher-forced (replay DES labels)
      SimNet.from_artifact(path)             load a saved artifact
      SimNet.train(data, pcfg, ...)          train, session owns the result

    All simulate entry points submit to a `SimServe` (a private
    one-resident-model service by default; pass ``service=`` to join a
    shared one) and run as packed lane batches; ``chunk`` bounds device
    memory for long traces, ``cache`` overrides the device's program
    cache. ``background=True`` starts the service's drain loop so simulate
    calls wait on their job handles instead of draining on the caller's
    thread (sessions are context managers: ``with SimNet(background=True)
    as sn: ...``). ``device`` (default ``cuda``) holds the engine and its
    private service; ``mesh`` (a ``DeviceMesh``, this rank its controller)
    shards the lane axis, and closing the session ends the mesh's
    followers (`serving.simnet_engine.follow`).
    """

    _session_ids = itertools.count()

    def __init__(
        self,
        artifact: Optional[PredictorArtifact] = None,
        *,
        params=None,
        pcfg: Optional[PredictorConfig] = None,
        sim_cfg: Optional[SimConfig] = None,
        mesh=None,
        use_kernel: bool = False,
        chunk: int = 1024,
        train_result: Optional[TrainResult] = None,
        service: Optional[SimServe] = None,
        model_id: Optional[str] = None,
        cache=None,
        background: bool = False,
        device: DeviceLike = None,
    ):
        self._metadata: Dict[str, Any] = {}
        if artifact is not None:
            if params is not None or pcfg is not None:
                raise ValueError("pass either an artifact or params/pcfg, not both")
            params, pcfg = artifact.params, artifact.pcfg
            sim_cfg = sim_cfg or artifact.sim_cfg
            self._metadata = dict(artifact.metadata)  # keep saved provenance
        if params is not None and pcfg is None:
            raise ValueError("pcfg is required when params are given")
        self.pcfg = pcfg
        self.sim_cfg = sim_cfg or (
            SimConfig(ctx_len=pcfg.ctx_len) if pcfg is not None else SimConfig()
        )
        self.chunk = chunk
        self.train_result = train_result
        self.engine = SimNetEngine(
            params, pcfg, self.sim_cfg, mesh=mesh, use_kernel=use_kernel, device=device,
            cache=cache,
        )
        self.device = self.engine.device
        self.params = self.engine.params  # on the session's device
        # the session's predictor becomes a resident model in a service —
        # a private single-model SimServe unless the caller shares one
        self._owns_service = service is None
        self.service = service or SimServe(
            chunk=chunk, cache=self.engine.cache, device=self.device
        )
        kind = pcfg.kind if pcfg is not None else "teacher-forced"
        self.model_id = self.service.register_engine(
            model_id or f"session{next(self._session_ids)}-{kind}", self.engine
        )
        if background:
            # the session rides the service's background drain loop:
            # simulate* submits and waits on handles, never draining on
            # the caller's thread (start() is idempotent on a shared one)
            self.service.start()

    def __repr__(self):
        head = self.pcfg.kind if self.pcfg is not None else "teacher-forced"
        return f"SimNet({head}, ctx_len={self.sim_cfg.ctx_len})"

    def close(self):
        """Evict this session's resident model from its service registry
        (matters when many short-lived sessions join a shared service);
        a private background drain loop is stopped too, and a lane mesh's
        followers are released."""
        if self._owns_service and self.service.running:
            self.service.stop()
        self.service.registry.remove(self.model_id)
        self.engine.close()

    def __enter__(self) -> "SimNet":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def stats(self) -> Dict[str, Any]:
        """The session's service observability: the underlying `SimServe`'s
        atomic ``stats()`` snapshot (job/batch counters, latency and
        occupancy histograms, circuit-breaker states). On a shared service
        the snapshot covers every session riding it."""
        return self.service.stats()

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def from_artifact(cls, path, device: DeviceLike = None, **kw) -> "SimNet":
        """Load a saved artifact onto ``device`` (default ``cuda``)."""
        return cls(PredictorArtifact.load(path, device=device), device=device, **kw)

    @classmethod
    def train(
        cls,
        data: Union[Mapping[str, np.ndarray], Sequence[TraceLike]],
        pcfg: PredictorConfig,
        sim_cfg: Optional[SimConfig] = None,
        *,
        epochs: int = 10,
        batch_size: int = 512,
        lr: float = 1e-3,
        seed: int = 0,
        log_every: int = 0,
        eval_errors: bool = True,
        **session_kw,
    ) -> "SimNet":
        """Train a predictor and return the session that owns it.

        ``data``: a built dataset dict (train_x/... splits) or a sequence of
        labelled Traces (the teacher-forced dataset is built on the fly).
        The dataset, the trainer and the session run on
        ``session_kw["device"]`` (default ``cuda``).
        """
        device = session_kw.get("device")
        sim_cfg = sim_cfg or SimConfig(ctx_len=pcfg.ctx_len)
        if not isinstance(data, Mapping):
            data = build_dataset(list(data), sim_cfg, device=device)
        t0 = time.time()
        params, history = train_loop(
            data, pcfg, epochs=epochs, batch_size=batch_size, lr=lr,
            seed=seed, log_every=log_every, device=device,
        )
        errs = None
        if eval_errors and "test_x" in data and len(data["test_x"]):
            errs = prediction_errors(params, pcfg, data["test_x"], data["test_y"])
        result = TrainResult(
            kind=pcfg.kind,
            output=pcfg.output,
            ctx_len=pcfg.ctx_len,
            epochs=epochs,
            n_train=len(data["train_x"]),
            train_loss=tuple(history["train_loss"]),
            val_loss=tuple(history["val_loss"]),
            seconds=time.time() - t0,
            pred_errors=errs,
        )
        return cls(
            params=params, pcfg=pcfg, sim_cfg=sim_cfg,
            train_result=result, **session_kw,
        )

    @property
    def artifact(self) -> PredictorArtifact:
        if self.params is None:
            raise ValueError("teacher-forced session has no predictor to export")
        meta = dict(self._metadata)  # provenance carried from a loaded artifact
        if self.train_result is not None:
            meta["train"] = self.train_result.to_dict()
        return PredictorArtifact(
            params=self.params, pcfg=self.pcfg, sim_cfg=self.sim_cfg, metadata=meta
        )

    def save(self, path, metadata: Optional[Mapping[str, Any]] = None):
        """Write this session's predictor as a PredictorArtifact directory."""
        art = self.artifact
        if metadata:
            art = PredictorArtifact(
                art.params, art.pcfg, art.sim_cfg, {**art.metadata, **metadata}
            )
        return art.save(path)

    # ----------------------------------------------------------- simulation

    def simulate_many(
        self,
        traces: Sequence[TraceLike],
        n_lanes: Union[int, Sequence[int]] = 8,
        *,
        sim_cfgs: Union[SimConfig, Sequence[SimConfig], None] = None,
        chunk: Optional[int] = None,
        timeit: bool = False,
    ) -> SimResult:
        """Pack all workloads onto one lane axis and run THE simulation path:
        submit every workload to the session's `SimServe` and drain — the
        scheduler packs them into shared, lane-bucketed batches against the
        session's resident predictor (chunked resident programs).

        ``traces`` are labelled `des.trace.Trace` objects (DES comparison
        fields filled in) or raw trace_arrays dicts. ``n_lanes`` and
        ``sim_cfgs`` may be per-workload. timeit=True re-streams the pack
        once built so throughput is steady-state.
        """
        traces = list(traces)
        if not traces:
            raise ValueError("simulate_many needs at least one workload")
        lanes = [n_lanes] * len(traces) if isinstance(n_lanes, int) else list(n_lanes)
        if len(lanes) != len(traces):
            raise ValueError(f"n_lanes has {len(lanes)} entries for {len(traces)} workloads")
        if sim_cfgs is None or isinstance(sim_cfgs, SimConfig):
            cfgs = [sim_cfgs] * len(traces)
        else:
            cfgs = list(sim_cfgs)
        if len(cfgs) != len(traces):
            raise ValueError(f"sim_cfgs has {len(cfgs)} entries for {len(traces)} workloads")
        handles = []
        try:
            for i, (t, ln, cfg) in enumerate(zip(traces, lanes, cfgs)):
                handles.append(self.service.submit(
                    t, self.model_id,
                    n_lanes=int(ln), sim_cfg=cfg, timeit=timeit,
                    chunk=chunk or self.chunk,
                    name=getattr(t, "name", None) or f"workload{i}",
                ))
        except Exception:
            # a rejected job must not leave its batchmates queued — they
            # would ride (and skew) the next unrelated simulate call
            for h in handles:
                self.service.cancel(h)
            raise
        try:
            if not self.service.running:
                # synchronous service: drain on this thread. With the
                # background loop running the drain happens there and
                # result() blocks on each job's completion event.
                self.service.drain()
            workloads = tuple(h.result() for h in handles)
        except Exception:
            # same invariant when a batch dies mid-drain: withdraw this
            # call's still-pending jobs (ran/errored ones are unaffected)
            for h in handles:
                self.service.cancel(h)
            raise
        reports, seen = [], set()
        for h in handles:
            if id(h.batch) not in seen:
                seen.add(id(h.batch))
                reports.append(h.batch)
        # instruction/cycle totals cover THIS call's workloads only (on a
        # shared service a batch may also carry other clients' jobs);
        # seconds are the wall time of the dispatches that served them
        seconds = sum(r.seconds for r in reports)
        total_instructions = sum(w.n_instructions for w in workloads)
        return SimResult(
            workloads=workloads,
            total_cycles=sum(w.total_cycles for w in workloads),
            total_instructions=total_instructions,
            throughput_ips=total_instructions / seconds,
            seconds=seconds,
            first_call_seconds=sum(r.first_call_seconds for r in reports),
            cache={
                k: sum(r.cache[k] for r in reports)
                for k in ("hits", "misses", "compile_seconds")
            },
        )

    def simulate(
        self,
        trace: TraceLike,
        n_lanes: int = 16,
        *,
        chunk: Optional[int] = None,
        timeit: bool = False,
    ) -> SimResult:
        """Single-workload simulation = the 1-workload pack (same path).

        timeit=True re-streams a device-staged copy of the whole pack for
        steady-state throughput — device memory O(trace), so keep it for
        benchmark-sized traces; the default streams O(chunk)."""
        return self.simulate_many(
            [trace], n_lanes=n_lanes, chunk=chunk, timeit=timeit
        )

    def sweep(
        self,
        jobs: Union[Mapping[str, Any], Sequence[tuple]],
        n_lanes: Union[int, Sequence[int]] = 8,
        *,
        chunk: Optional[int] = None,
        timeit: bool = False,
    ) -> SweepResult:
        """Design-space sweep: every point's workloads ride ONE packed call.

        ``jobs``: mapping label → trace (or sequence of traces), or a
        sequence of (label, trace) / (label, trace, SimConfig) tuples — the
        3-tuple form sweeps processor SimConfigs (ctx_len / retire_width)
        without retraining, the paper's §5 use case. Workload names must be
        unique within a point (they key the relative-accuracy readout).
        """
        labels, traces, cfgs = [], [], []
        any_cfg = False
        if isinstance(jobs, Mapping):
            items = []
            for label, t in jobs.items():
                ts = t if isinstance(t, (list, tuple)) else [t]
                items.extend((label, x) for x in ts)
        else:
            items = list(jobs)
        for job in items:
            label, t = job[0], job[1]
            cfg = job[2] if len(job) > 2 else None
            any_cfg = any_cfg or cfg is not None
            labels.append(label)
            traces.append(t)
            cfgs.append(cfg if cfg is not None else self.sim_cfg)
        res = self.simulate_many(
            traces, n_lanes=n_lanes,
            sim_cfgs=cfgs if any_cfg else None, chunk=chunk, timeit=timeit,
        )
        return SweepResult(labels=tuple(labels), result=res)
