"""Instruction-centric SimNet simulator in PyTorch (paper §3).

The port of ``repro.core.simulator``: the same state, the same two step
layouts and the same packed multi-workload path, with the same public
layouts — lane-major ``(L, Q, ...)`` state planes and time-major
``(T, L, ...)`` packs — so the two packages are compared like with like.

State per lane: an in-flight buffer that plays both paper queues — entries
carry an ``in_mw`` flag that flips when a retired store moves to the
memory-write queue. One step = one instruction: assemble the model input
from the buffer, predict (or teacher-force) the three latencies, advance
the clock, retire in order, push.

Step layouts (``SimConfig.layout``):

  "ring" (default) — slots form a ring buffer with a global ``head`` write
    cursor. A push writes ONE slot per plane (``index_copy_`` at the head,
    in place: the wide planes of the state passed to ``sim_step`` are
    updated, so a caller must not keep using the old state). Recency order
    is recovered by index arithmetic (`recency_view`).
  "roll" — the shift-push layout (slot 0 = physically newest; every plane
    moves one slot per step), kept as the exactness reference. The ring
    step reproduces `_retire`'s recency-ordered decisions in physical order
    with head-anchored cyclic prefix sums, so per-lane totals are
    bit-identical between the layouts.

The head cursor stays a device tensor: every dynamic slice of the reference
(``jnp.roll(a, -head)``, ``dynamic_slice_in_dim``, ``take_along_axis``,
``dynamic_update_slice_in_dim``) becomes ``index_select``/``gather``/
``index_copy_`` with a device index, so a step never waits for the host.

Lanes are the paper's sub-traces; lanes from many workloads × SimConfigs
share one scan (per-lane workload id, retire width, context capacity and a
per-step validity mask for ragged lengths — a finished lane freezes), and
per-workload totals come out of one ``index_add_`` over the lane axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import features as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32" / "bfloat16")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    ctx_len: int = 64  # in-flight buffer capacity = max context instructions
    retire_width: int = 8
    n_classes: int = 10  # hybrid head classes per latency type
    max_latency: float = 100000.0
    state_dtype: str = "float32"  # "bfloat16" halves the queue-state HBM
    # traffic that the ring layout has not already eliminated; cycle
    # counters stay f32 so totals are exact.
    layout: str = "ring"  # "ring" = O(1)-push slot writes + head cursor;
    # "roll" = shift-push every plane (the original exactness reference).
    # Totals are bit-identical between the two (the ring step reproduces
    # the roll retirement decisions with exact integer math — see the
    # module docstring).

    def __post_init__(self):
        if self.layout not in ("ring", "roll"):
            raise ValueError(f"layout must be 'ring' or 'roll', got {self.layout!r}")


class SimState(NamedTuple):
    feat: torch.Tensor  # (L, Q, 41) static blocks of in-flight instrs
    addr: torch.Tensor  # (L, Q, 5) int32 comparison keys
    resid: torch.Tensor  # (L, Q) f32 cycles since entry
    exec_lat: torch.Tensor  # (L, Q) f32 predicted execution latency
    store_lat: torch.Tensor  # (L, Q) f32 predicted store latency
    valid: torch.Tensor  # (L, Q) bool
    in_mw: torch.Tensor  # (L, Q) bool — retired store awaiting memory write
    is_store_q: torch.Tensor  # (L, Q) bool — store marker of in-flight
    # entries (duplicates feat[:, :, 7] so retirement never reads feat)
    cur_tick: torch.Tensor  # (L,) f32
    overflow: torch.Tensor  # (L,) i32 force-dropped entries (diagnostic)
    head: torch.Tensor  # () i32 ring write cursor (stays 0 in roll layout).
    # GLOBAL, not per-lane: every step advances it whether or not a lane is
    # active. A frozen lane's planes never change and nothing that survives
    # the freeze (drain, totals, overflow) depends on recency order, so
    # reading a frozen buffer under a moved head is harmless. Inactivity
    # must be terminal (pack_workloads masks only ragged tails).


def init_state(n_lanes: int, cfg: SimConfig, device: DeviceLike = None) -> SimState:
    dev = resolve_device(device)
    L, Q = n_lanes, cfg.ctx_len
    sd = torch_dtype(cfg.state_dtype)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SimState(
        feat=zeros((L, Q, F.STATIC_END), sd),
        addr=zeros((L, Q, F.N_ADDR_KEYS), torch.int32),
        resid=zeros((L, Q), torch.float32),  # cycle counters stay exact
        exec_lat=zeros((L, Q), torch.float32),
        store_lat=zeros((L, Q), torch.float32),
        valid=zeros((L, Q), torch.bool),
        in_mw=zeros((L, Q), torch.bool),
        is_store_q=zeros((L, Q), torch.bool),
        cur_tick=zeros((L,), torch.float32),
        overflow=zeros((L,), torch.int32),
        head=zeros((), torch.int32),
    )


def _recency_index(head: torch.Tensor, Q: int) -> torch.Tensor:
    """(Q,) int64 physical slot of each recency r: (head - 1 - r) mod Q."""
    r = torch.arange(Q, device=head.device)
    return torch.remainder(head.long() - 1 - r, Q)


def recency_view(state: SimState) -> SimState:
    """Ring-layout state reordered so index 0 = newest (the roll layout's
    physical invariant): recency r lives at slot (head - 1 - r) mod Q.
    Values are moved, never recomputed, so anything derived from the view
    is bit-identical to the roll path."""
    idx = _recency_index(state.head, state.valid.shape[1])

    def rec(a):
        return a.index_select(1, idx)

    return state._replace(
        feat=rec(state.feat), addr=rec(state.addr), resid=rec(state.resid),
        exec_lat=rec(state.exec_lat), store_lat=rec(state.store_lat),
        valid=rec(state.valid), in_mw=rec(state.in_mw),
        is_store_q=rec(state.is_store_q),
    )


def model_input(state: SimState, cur_feat, cur_addr, cfg: SimConfig):
    """Layout-aware input assembly: recency-order the ring state first."""
    if cfg.layout == "ring":
        state = recency_view(state)
    return build_model_input(state, cur_feat, cur_addr)


def build_model_input(state: SimState, cur_feat, cur_addr):
    """Assemble (L, 1+Q, 50): current instruction + context, recency order
    (the state must already be recency-ordered — roll layout, or a ring
    state through `recency_view`). Latencies and flags are rounded through
    the state dtype at the same points as the reference."""
    L = state.feat.shape[0]
    sd = state.feat.dtype
    dev = state.feat.device
    dep = (state.addr == cur_addr[:, None, :]) & (cur_addr[:, None, :] != 0)  # (L, Q, 5)
    valid_f = state.valid.to(sd)
    ctx = torch.cat(
        [
            state.feat,
            (state.resid * F.LAT_SCALE)[..., None].to(sd),
            (state.exec_lat * F.LAT_SCALE)[..., None].to(sd),
            (state.store_lat * F.LAT_SCALE)[..., None].to(sd),
            dep.to(sd),
            valid_f[..., None],
        ],
        dim=-1,
    )  # (L, Q, 50)
    ctx = ctx * valid_f[..., None]  # zero out padding rows entirely
    cur = torch.cat(
        [
            cur_feat.to(sd),
            torch.zeros((L, 3 + 5), dtype=sd, device=dev),
            torch.ones((L, 1), dtype=sd, device=dev),
        ],
        dim=-1,
    )  # (L, 50)
    return torch.cat([cur[:, None, :], ctx], dim=1)  # (L, 1+Q, 50)


def _suffix_count(x):
    """suffix_count[q] = sum(x[q+1:]) along the last axis."""
    xi = x.to(torch.int32)
    rev_cs = torch.flip(torch.cumsum(torch.flip(xi, [-1]), dim=-1), [-1])
    return rev_cs - xi


def _suffix_any(x):
    """suffix_any[q] = any(x[q+1:]) along the last axis."""
    return _suffix_count(x) > 0


def _lane_where(active, new, old):
    """Per-lane select: keep `old` where the lane is inactive this step."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return torch.where(a, new, old)


def _clip_lats(cur, lats, cfg: SimConfig):
    """Round/clip the three predicted latencies (shared by both layouts).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    fetch, exec_lat, store_lat = lats[:, 0], lats[:, 1], lats[:, 2]
    fetch = torch.clamp(torch.round(fetch), 0, cfg.max_latency)
    exec_lat = torch.clamp(torch.round(exec_lat), 1, cfg.max_latency)
    store_lat = torch.where(
        cur["is_store"], torch.clamp(torch.round(store_lat), 1, cfg.max_latency), 0.0
    )
    return fetch, exec_lat, store_lat


def _budget(fetch, cfg: SimConfig, retire_width):
    """Per-lane retire budget, truncated to int32 like ``astype(int32)``."""
    rw = float(cfg.retire_width) if retire_width is None else retire_width.to(torch.float32)
    return (rw * torch.clamp(fetch, min=1.0)).to(torch.int32)  # (L,)


def _retire(valid, in_mw, resid, exec_lat, store_lat, is_store, fetch, cfg,
            retire_width):
    """Both paper queues' retirement over RECENCY-ordered (L, Q) planes
    (index 0 = newest) — the roll layout's in-place path."""
    # --- processor-queue retirement: in-order, bandwidth-limited ---
    budget = _budget(fetch, cfg, retire_width)
    proc = valid & ~in_mw
    ready_p = proc & (resid >= exec_lat)
    blocked = proc & ~ready_p
    eligible = ready_p & ~_suffix_any(blocked)
    retire_p = eligible & (_suffix_count(eligible) < budget[:, None])
    # retired stores move to the memory-write queue; others leave
    to_mw = retire_p & is_store
    in_mw = in_mw | to_mw
    valid = valid & ~(retire_p & ~to_mw)

    # --- memory-write queue retirement: in-order, unlimited ---
    mw = valid & in_mw
    ready_m = mw & (resid >= store_lat)
    blocked_m = mw & ~ready_m
    retire_m = ready_m & ~_suffix_any(blocked_m)
    valid = valid & ~retire_m
    in_mw = in_mw & valid
    return valid, in_mw


def sim_step(
    state: SimState,
    cur,
    lats,
    cfg: SimConfig,
    *,
    active: Optional[torch.Tensor] = None,
    retire_width: Optional[torch.Tensor] = None,
    lane_ctx: Optional[torch.Tensor] = None,
) -> SimState:
    """Advance one instruction. cur: dict(feat (L,41), addr (L,5),
    is_store (L,)); lats: (L, 3) predicted/true (fetch, exec, store).

    Optional per-lane controls (packed multi-workload mode):
      active (L,) bool — lanes with False keep their state unchanged.
      retire_width (L,) i32 — per-lane processor retire bandwidth.
      lane_ctx (L,) i32 — per-lane in-flight capacity ≤ cfg.ctx_len;
        entries pushed past it are force-dropped and counted in
        ``overflow`` exactly as a standalone run with that ctx_len would.

    The ring layout updates the wide planes of ``state`` in place.
    """
    if cfg.layout == "ring":
        return _sim_step_ring(
            state, cur, lats, cfg,
            active=active, retire_width=retire_width, lane_ctx=lane_ctx,
        )
    fetch, exec_lat, store_lat = _clip_lats(cur, lats, cfg)

    # clock + residence advance
    cur_tick = state.cur_tick + fetch
    resid = state.resid + torch.where(state.valid, fetch[:, None], 0.0)

    # roll layout: slot index IS recency order, retire in place
    valid, in_mw = _retire(
        state.valid, state.in_mw, resid, state.exec_lat, state.store_lat,
        state.is_store_q, fetch, cfg, retire_width,
    )

    # --- push current instruction at slot 0 (roll the buffer) ---
    Q = state.valid.shape[1]
    if lane_ctx is None:
        overflow = state.overflow + valid[:, -1].to(torch.int32)
    else:
        # entry at the lane's own capacity boundary is force-dropped on push
        idx = torch.clamp(lane_ctx - 1, 0, Q - 1).long()
        at_cap = torch.gather(valid, 1, idx[:, None])[:, 0]
        overflow = state.overflow + at_cap.to(torch.int32)

    def push(buf, new):
        return torch.cat([new[:, None].to(buf.dtype), buf[:, :-1]], dim=1)

    valid_new = push(valid, torch.ones_like(fetch, dtype=torch.bool))
    in_mw_new = push(in_mw, torch.zeros_like(fetch, dtype=torch.bool))
    if lane_ctx is not None:
        keep = torch.arange(Q, device=lane_ctx.device)[None, :] < lane_ctx[:, None]
        valid_new = valid_new & keep
        in_mw_new = in_mw_new & keep

    new_state = SimState(
        feat=push(state.feat, cur["feat"]),
        addr=push(state.addr, cur["addr"]),
        resid=push(resid, torch.zeros_like(fetch)),
        exec_lat=push(state.exec_lat, exec_lat),
        store_lat=push(state.store_lat, store_lat),
        valid=valid_new,
        in_mw=in_mw_new,
        is_store_q=push(state.is_store_q, cur["is_store"]),
        cur_tick=cur_tick,
        overflow=overflow,
        head=state.head,
    )
    if active is None:
        return new_state
    # head is a global scalar (last field) — lane-select every other plane
    merged = [_lane_where(active, n, o)
              for n, o in zip(new_state[:-1], state[:-1])]
    return SimState(*merged, state.head)


def _sim_step_ring(
    state: SimState,
    cur,
    lats,
    cfg: SimConfig,
    *,
    active: Optional[torch.Tensor] = None,
    retire_width: Optional[torch.Tensor] = None,
    lane_ctx: Optional[torch.Tensor] = None,
) -> SimState:
    """Ring-layout step: the roll step's semantics, but the push writes
    ONE slot at the global ``head`` cursor, and retirement runs in
    PHYSICAL order: "how many set entries are strictly older than slot p"
    is a cyclic prefix sum anchored at the head cursor — exact integer
    arithmetic, bit-for-bit the roll layout's reversed cumsums."""
    L, Q = state.valid.shape
    fetch, exec_lat, store_lat = _clip_lats(cur, lats, cfg)

    # clock + residence advance (physical order: elementwise, no reorder)
    cur_tick = state.cur_tick + fetch
    resid = state.resid + torch.where(state.valid, fetch[:, None], 0.0)

    head = state.head  # () i32 — global write cursor (= step count mod Q)
    h = head.long().reshape(1)  # device index of the head slot
    slot = torch.arange(Q, device=head.device)[None, :]

    def older_count(x):
        """Per slot: how many set entries of ``x`` are OLDER in recency —
        the cyclic-range sum over [head, p), exact integer math."""
        xi = x.to(torch.int32)
        cs = torch.cumsum(xi, dim=-1)
        excl = cs - xi  # exclusive prefix sum in physical order
        total = cs[:, -1:]
        at_head = excl.index_select(1, h)  # (L, 1)
        return torch.where(slot >= head, excl - at_head, total - at_head + excl)

    # --- processor-queue retirement: in-order, bandwidth-limited ---
    budget = _budget(fetch, cfg, retire_width)
    proc = state.valid & ~state.in_mw
    ready_p = proc & (resid >= state.exec_lat)
    blocked = proc & ~ready_p
    eligible = ready_p & (older_count(blocked) == 0)
    retire_p = eligible & (older_count(eligible) < budget[:, None])
    # retired stores move to the memory-write queue; others leave
    to_mw = retire_p & state.is_store_q
    in_mw_p = state.in_mw | to_mw
    valid_p = state.valid & ~(retire_p & ~to_mw)

    # --- memory-write queue retirement: in-order, unlimited ---
    mw = valid_p & in_mw_p
    ready_m = mw & (resid >= state.store_lat)
    blocked_m = mw & ~ready_m
    retire_m = ready_m & (older_count(blocked_m) == 0)
    valid_p = valid_p & ~retire_m
    in_mw_p = in_mw_p & valid_p

    # push accounting (recency index r lives at slot (head - 1 - r) mod Q)
    if lane_ctx is None:
        # the oldest entry sits AT the head slot, about to be overwritten
        at_cap = valid_p.index_select(1, h)[:, 0]
    else:
        cap_slot = torch.remainder(head - lane_ctx, Q).long()  # (L,)
        at_cap = torch.gather(valid_p, 1, cap_slot[:, None])[:, 0]
        # entries whose post-push recency would reach the lane's capacity
        # are force-dropped now (the new entry itself is always kept)
        age = torch.remainder(head - 1 - slot, Q)  # (1, Q) — lane-independent
        keep = age < (lane_ctx[:, None] - 1)
        valid_p = valid_p & keep
        in_mw_p = in_mw_p & keep
    overflow = state.overflow + at_cap.to(torch.int32)

    # freeze inactive lanes on the planes that were rewritten above; the
    # wide planes below are only touched at the push slot, where the write
    # itself is made conditional
    if active is not None:
        resid = _lane_where(active, resid, state.resid)
        valid_p = _lane_where(active, valid_p, state.valid)
        in_mw_p = _lane_where(active, in_mw_p, state.in_mw)
        cur_tick = torch.where(active, cur_tick, state.cur_tick)
        overflow = torch.where(active, overflow, state.overflow)

    # --- O(1) push: one head-slot write per plane, in place ---
    def put(buf, new):
        """Write the (L, 1, ...) head slot; inactive lanes keep theirs."""
        new = new[:, None].to(buf.dtype)
        if active is not None:
            old = buf.index_select(1, h)
            sel = active.reshape((L, 1) + (1,) * (new.ndim - 2))
            new = torch.where(sel, new, old)
        return buf.index_copy_(1, h, new)

    return SimState(
        feat=put(state.feat, cur["feat"]),
        addr=put(state.addr, cur["addr"]),
        resid=put(resid, torch.zeros_like(fetch)),
        exec_lat=put(state.exec_lat, exec_lat),
        store_lat=put(state.store_lat, store_lat),
        valid=put(valid_p, torch.ones_like(fetch, dtype=torch.bool)),
        in_mw=put(in_mw_p, torch.zeros_like(fetch, dtype=torch.bool)),
        is_store_q=put(state.is_store_q, cur["is_store"]),
        cur_tick=cur_tick,
        overflow=overflow,
        # the cursor is global: it advances past frozen lanes too
        head=torch.remainder(head + 1, Q),
    )


def drain_cycles(state: SimState) -> torch.Tensor:
    """Δ of Eq. 1: cycles until the last in-flight instruction exits."""
    need = torch.maximum(state.exec_lat, state.store_lat) - state.resid
    need = torch.where(state.valid, need, 0.0)
    return torch.clamp(need, min=0.0).amax(dim=-1)


def make_sim_scan(
    predict_fn: Optional[Callable],
    cfg: SimConfig,
    *,
    retire_width: Optional[torch.Tensor] = None,
    lane_ctx: Optional[torch.Tensor] = None,
    emit_outputs: bool = True,
    predict_state_fn: Optional[Callable] = None,
):
    """Returns step(state, xs) -> (state, per-step outputs) for one time
    step; callers loop it over the time axis.

    xs: dict of (L, ...) tensors for this step (feat, addr, is_store,
    labels, and an optional "active" (L,) bool lane mask in packed mode).
    predict_fn: (L, 1+Q, 50) -> (L, 3) latencies. None = teacher forcing
    (emits the assembled model inputs instead). predict_state_fn:
    (state, cur_feat, cur_addr) -> (L, 3) — the fused-kernel entry (input
    assembly inside the predictor); overrides predict_fn when given.
    retire_width / lane_ctx: per-lane SimConfig overrides (see sim_step).
    emit_outputs=False returns empty per-step outputs.
    """

    # repro-lint: scan-reachable — the per-step body every scan loops over
    def step(state, xs):
        cur = {"feat": xs["feat"], "addr": xs["addr"], "is_store": xs["is_store"]}
        if predict_state_fn is not None:
            lats = predict_state_fn(state, cur["feat"], cur["addr"])
            out = {"lats": lats} if emit_outputs else {}
        elif predict_fn is None:
            lats = xs["labels"]
            out = {"x": model_input(state, cur["feat"], cur["addr"], cfg)} if emit_outputs else {}
        else:
            x = model_input(state, cur["feat"], cur["addr"], cfg)
            lats = predict_fn(x)  # sim_step zeroes store latency for non-stores
            out = {"lats": lats} if emit_outputs else {}
        new_state = sim_step(
            state, cur, lats, cfg,
            active=xs.get("active"), retire_width=retire_width, lane_ctx=lane_ctx,
        )
        return new_state, out

    return step


def run_steps(step, state: SimState, xs: dict):
    """Loop ``step`` over the leading time axis of ``xs`` ((T, L, ...)
    tensors). Returns (state, per-step outputs stacked on a leading T)."""
    outs = []
    for t in range(xs["feat"].shape[0]):
        state, out = step(state, {k: v[t] for k, v in xs.items()})
        outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]} if outs else {}
    return state, stacked


def simulate_trace(trace_arrays: dict, predict_fn, cfg: SimConfig, n_lanes: int,
                   device: DeviceLike = None):
    """Parallel simulation (paper §3.3): partition into equal sub-traces
    (lanes), simulate independently, total = Σ per-lane (ΣF + Δ).

    trace_arrays: dict of (T, ...) numpy arrays. Returns dict of results.
    """
    dev = resolve_device(device)
    T = trace_arrays["feat"].shape[0]
    per = T // n_lanes
    T_used = per * n_lanes

    def lanes_first(a):
        a = np.asarray(a)[:T_used].reshape(n_lanes, per, *a.shape[1:])
        return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 0, 1))).to(dev)

    xs = {k: lanes_first(v) for k, v in trace_arrays.items()}
    state = init_state(n_lanes, cfg, dev)
    state, outs = run_steps(make_sim_scan(predict_fn, cfg), state, xs)
    total = state.cur_tick + drain_cycles(state)
    return {
        "lane_cycles": total,
        "total_cycles": torch.sum(total),
        "overflow": torch.sum(state.overflow),
        "outs": outs,
        "n_instructions": T_used,
    }


# ---------------------------------------------------------------------------
# packed multi-workload simulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedWorkloads:
    """Lanes from many (workload, SimConfig) jobs packed on one lane axis.

    ``xs`` is time-major numpy: feat (T, L, 41), addr (T, L, 5), is_store
    (T, L), labels (T, L, 3), active (T, L) bool. Rows past a lane's own
    sub-trace length are zero-filled and inactive (ragged-length masking).
    """

    xs: dict
    workload_id: np.ndarray  # (L,) i32 — lane → job index
    retire_width: np.ndarray  # (L,) i32 per-lane retire bandwidth
    lane_ctx: np.ndarray  # (L,) i32 per-lane in-flight capacity
    lane_steps: np.ndarray  # (L,) i64 real (unpadded) steps per lane
    n_instructions: np.ndarray  # (W,) i64 packed instructions per job
    cfg: SimConfig  # unified config (ctx_len = max over jobs)
    uniform: bool  # True when every job shares retire_width/ctx_len

    @property
    def n_lanes(self) -> int:
        return int(self.workload_id.shape[0])

    @property
    def n_workloads(self) -> int:
        return int(self.n_instructions.shape[0])

    @property
    def n_steps(self) -> int:
        return int(self.xs["feat"].shape[0])


def pack_workloads(
    trace_arrays_list: Sequence[dict],
    n_lanes: Union[int, Sequence[int]] = 8,
    cfg: Union[SimConfig, Sequence[SimConfig], None] = None,
    pad_to: int = 1,
) -> PackedWorkloads:
    """Pack W workloads (each a `trace_arrays` dict) into one lane batch.

    n_lanes / cfg may be per-workload sequences; the packed scan runs with
    ctx_len = max over jobs, and per-lane retire_width / lane_ctx replay
    each job's own SimConfig exactly. ``pad_to`` rounds the time axis up
    (with inactive steps) so chunked streaming never needs a ragged tail.
    """
    W = len(trace_arrays_list)
    if W == 0:
        raise ValueError("pack_workloads needs at least one workload")
    lanes = [n_lanes] * W if isinstance(n_lanes, int) else list(n_lanes)
    if len(lanes) != W:
        raise ValueError(f"n_lanes has {len(lanes)} entries for {W} workloads")
    if cfg is None:
        cfgs = [SimConfig()] * W
    elif isinstance(cfg, SimConfig):
        cfgs = [cfg] * W
    else:
        cfgs = list(cfg)
    if len(cfgs) != W:
        raise ValueError(f"cfg has {len(cfgs)} entries for {W} workloads")
    # ctx_len and retire_width are replayed per lane; every other SimConfig
    # field is shared scan state and must agree or exactness would silently
    # break (e.g. a per-job max_latency would clip with the wrong bound)
    base = cfgs[0]
    for c in cfgs[1:]:
        if dataclasses.replace(c, ctx_len=base.ctx_len, retire_width=base.retire_width) != base:
            raise ValueError(
                "pack_workloads replays only ctx_len/retire_width per workload; "
                f"other SimConfig fields must match across jobs ({c} vs {base})"
            )

    per = []
    for arrs, ln in zip(trace_arrays_list, lanes):
        T = arrs["feat"].shape[0]
        if T < ln:
            raise ValueError(f"workload of {T} instructions cannot fill {ln} lanes")
        per.append(T // ln)
    T_max = max(per)
    T_max = ((T_max + pad_to - 1) // pad_to) * pad_to
    L = sum(lanes)
    Q = max(c.ctx_len for c in cfgs)
    ucfg = dataclasses.replace(cfgs[0], ctx_len=Q)

    xs = {
        "feat": np.zeros((T_max, L, F.STATIC_END), np.float32),
        "addr": np.zeros((T_max, L, F.N_ADDR_KEYS), np.int32),
        "is_store": np.zeros((T_max, L), bool),
        "labels": np.zeros((T_max, L, 3), np.float32),
        "active": np.zeros((T_max, L), bool),
    }
    workload_id = np.zeros(L, np.int32)
    retire_width = np.zeros(L, np.int32)
    lane_ctx = np.zeros(L, np.int32)
    lane_steps = np.zeros(L, np.int64)
    n_instructions = np.zeros(W, np.int64)

    lo = 0
    for w, (arrs, ln, c, p) in enumerate(zip(trace_arrays_list, lanes, cfgs, per)):
        hi = lo + ln
        used = p * ln
        for k in ("feat", "addr", "is_store", "labels"):
            a = np.asarray(arrs[k])[:used]
            xs[k][:p, lo:hi] = np.swapaxes(a.reshape(ln, p, *a.shape[1:]), 0, 1)
        xs["active"][:p, lo:hi] = True
        workload_id[lo:hi] = w
        retire_width[lo:hi] = c.retire_width
        lane_ctx[lo:hi] = c.ctx_len
        lane_steps[lo:hi] = p
        n_instructions[w] = used
        lo = hi

    uniform = all(
        c.retire_width == cfgs[0].retire_width and c.ctx_len == Q for c in cfgs
    )
    return PackedWorkloads(
        xs=xs, workload_id=workload_id, retire_width=retire_width,
        lane_ctx=lane_ctx, lane_steps=lane_steps,
        n_instructions=n_instructions, cfg=ucfg, uniform=uniform,
    )


def pad_packed_lanes(packed: PackedWorkloads, n_lanes: int) -> PackedWorkloads:
    """Grow a pack's lane axis to ``n_lanes`` with dead lanes (lane
    bucketing). Dead lanes are inactive at every step, so they freeze in
    their all-zero initial state and add exactly nothing to any total."""
    L = packed.n_lanes
    if n_lanes < L:
        raise ValueError(f"cannot shrink a {L}-lane pack to {n_lanes} lanes")
    if n_lanes == L:
        return packed
    pad = n_lanes - L
    xs = {
        k: np.concatenate(
            [v, np.zeros((v.shape[0], pad) + v.shape[2:], v.dtype)], axis=1
        )
        for k, v in packed.xs.items()
    }

    def lane_pad(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return dataclasses.replace(
        packed,
        xs=xs,
        # id 0 is safe: a dead lane's totals are exactly zero
        workload_id=lane_pad(packed.workload_id, 0),
        retire_width=lane_pad(packed.retire_width, 1),
        lane_ctx=lane_pad(packed.lane_ctx, packed.cfg.ctx_len),
        lane_steps=lane_pad(packed.lane_steps, 0),
    )


def max_packed_steps(
    trace_arrays_list: Sequence[dict], n_lanes: Union[int, Sequence[int]]
) -> int:
    """Longest per-lane sub-trace over a prospective pack (= the packed time
    axis before pad_to rounding)."""
    W = len(trace_arrays_list)
    lanes = [n_lanes] * W if isinstance(n_lanes, int) else list(n_lanes)
    return max(
        int(a["feat"].shape[0]) // ln for a, ln in zip(trace_arrays_list, lanes)
    )


def workload_totals(state: SimState, packed: PackedWorkloads):
    """Per-workload (cycles, overflow) via ``index_add_`` over the lane
    axis. On CUDA the adds are atomics in a varying order; lane totals are
    integer-valued f32, so the sum is exact while a workload stays below
    2**24 cycles."""
    lane_total = state.cur_tick + drain_cycles(state)
    cycles, overflow = lane_sums(lane_total, state.overflow, packed)
    return lane_total, cycles, overflow


def lane_sums(lane_total: torch.Tensor, lane_overflow: torch.Tensor, packed: PackedWorkloads):
    """Per-workload sums of the (L,) per-lane cycle totals and overflow
    counts of ``packed``'s lanes, on their device."""
    dev = lane_total.device
    wid = torch.from_numpy(packed.workload_id.astype(np.int64)).to(dev)
    W = packed.n_workloads
    cycles = torch.zeros(W, dtype=lane_total.dtype, device=dev).index_add_(0, wid, lane_total)
    overflow = torch.zeros(W, dtype=torch.int32, device=dev).index_add_(0, wid, lane_overflow)
    return cycles, overflow


def packed_tensors(packed: PackedWorkloads, device: torch.device, lo: int = 0,
                   hi: Optional[int] = None) -> dict:
    """Time steps [lo, hi) of a pack's ``xs`` as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(device)
            for k, v in packed.xs.items()}


def simulate_many(
    trace_arrays_list: Sequence[dict],
    predict_fn: Optional[Callable],
    cfg: Union[SimConfig, Sequence[SimConfig], None] = None,
    n_lanes: Union[int, Sequence[int]] = 8,
    device: DeviceLike = None,
) -> dict:
    """Batched multi-workload simulation: one scan over all packed lanes.

    Teacher-forced (predict_fn=None) per-workload totals are bit-identical
    to W separate `simulate_trace` calls with each job's own SimConfig.
    """
    dev = resolve_device(device)
    packed = pack_workloads(trace_arrays_list, n_lanes, cfg)
    rw = None if packed.uniform else torch.from_numpy(packed.retire_width).to(dev)
    lc = None if packed.uniform else torch.from_numpy(packed.lane_ctx).to(dev)
    step = make_sim_scan(
        predict_fn, packed.cfg, retire_width=rw, lane_ctx=lc, emit_outputs=False
    )
    state = init_state(packed.n_lanes, packed.cfg, dev)
    state, _ = run_steps(step, state, packed_tensors(packed, dev))
    lane_total, cycles, overflow = workload_totals(state, packed)
    return {
        "lane_cycles": lane_total,
        "workload_cycles": cycles,
        "workload_overflow": overflow,
        "total_cycles": torch.sum(cycles),
        "n_instructions": packed.n_instructions,
        "workload_id": packed.workload_id,
        "n_lanes": packed.n_lanes,
        "n_steps": packed.n_steps,
    }
