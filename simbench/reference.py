"""The plain reference of the benchmark's configurations: SimNet's
simulator in the roll layout and its C3 and RB7 predictors with the hybrid
decode (Li et al., arXiv:2105.05821, §2.3 and §3), in float32 PyTorch.

It follows the paper's semantics and the reference package's layouts, and
shares no code with the program under test (``repro_torch``): no kernel,
no ring buffer, no packing, no CUDA graph. Each job's trace is split into
``lanes`` equal contiguous sub-traces (the paper's parallel simulation,
§3.3); each lane steps one instruction at a time:

1. the model input: the current instruction's 41 static features, then
   its context, newest first: each in-flight entry's static features, its
   residence, execution and store latencies times 1/64, five dependency
   flags against the current instruction's address keys and a valid bit;
   invalid rows all zero; padded with zero rows to the trunk's length;
2. the predictor's raw outputs and the hybrid decode: per latency the
   argmax of 10 classes, the last one meaning "use the regression head";
3. the clock: the fetch latency is added to the lane's clock and to every
   in-flight entry's residence;
4. retirement in order: the processor queue retires up to retire_width ×
   max(fetch, 1) entries whose residence reached their execution latency
   and that nothing older blocks; retired stores move to the memory-write
   queue, which retires in order once residence reaches the store
   latency;
5. the push: the current instruction enters at slot 0; an entry pushed to
   the lane's capacity is dropped and counted as overflow.

A lane's cycles are its clock plus the drain (the largest remaining
latency of what is still in flight); a job's are the sum over its lanes.

``precision="tf32"`` rounds both operands of every matrix product to
TF32 (10 mantissa bits, round to nearest) and accumulates in float32: the
benchmark's control, the step below the configuration's float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

STATIC = 41  # static feature columns of an instruction
N_ADDR = 5  # address keys: pc, fetch line, data address, data line, page
N_IN = 50  # model input columns
LAT_SCALE = 1.0 / 64.0
REG_SCALE = 1.0 / 64.0
N_HEADS = 3  # fetch, execution, store


def n_stride2(cfg: dict) -> int:
    if cfg["kind"].startswith("c"):
        return len(cfg["channels"][: int(cfg["kind"][1])])
    return min(4, cfg["rb_blocks"])


def seq_padded(cfg: dict) -> int:
    m = 1 << n_stride2(cfg)
    return (cfg["ctx_len"] + 1 + m - 1) // m * m


def out_dim(cfg: dict) -> int:
    return N_HEADS * (cfg["n_classes"] + 1)


def param_shapes(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    """The weight layout of a c1/c3 or rb* predictor: {layer: {"w": (in,
    out), "b": (out,)}} (rb blocks nest "expand", "mix", "project")."""
    def dense(i, o):
        return {"w": (i, o), "b": (o,)}

    kind = cfg["kind"]
    if kind in ("c1", "c3"):
        chans = [N_IN] + list(cfg["channels"][: int(kind[1])])
        shapes = {f"conv{i}": dense(2 * chans[i], chans[i + 1]) for i in range(len(chans) - 1)}
        d_trunk = (seq_padded(cfg) >> (len(chans) - 1)) * chans[-1]
    elif kind.startswith("rb"):
        c = cfg["channels"][-1]
        shapes = {"stem": dense(2 * N_IN, c)}
        for i in range(cfg["rb_blocks"]):
            shapes[f"rb{i}"] = {"expand": dense(c, 2 * c), "mix": dense(4 * c, 2 * c),
                                "project": dense(2 * c, c)}
        d_trunk = (seq_padded(cfg) >> n_stride2(cfg)) * c
    else:
        raise ValueError(f"the reference has no predictor of kind {kind!r}")
    shapes["fc0"] = dense(d_trunk, cfg["hidden"])
    shapes["fc1"] = dense(cfg["hidden"], out_dim(cfg))
    return shapes


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32: 13 low mantissa bits dropped, to nearest."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul(precision: str):
    if precision == "f32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: torch.matmul(_tf32(a), _tf32(b))
    raise ValueError(f"precision must be 'f32' or 'tf32', got {precision!r}")


def predictor_raw(params, x: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """(B, N, 50) model inputs -> (B, 33) raw head outputs."""
    B = x.shape[0]
    h = torch.nn.functional.pad(x, (0, 0, 0, seq_padded(cfg) - x.shape[1]))

    def dense(p, v, relu=False):
        y = mm(v, p["w"]) + p["b"]
        return torch.relu(y) if relu else y

    def k2s2(p, v):  # kernel 2, stride 2: two rows side by side, one product
        n, c = v.shape[1], v.shape[2]
        return dense(p, v.reshape(v.shape[0], n // 2, 2 * c), relu=True)

    if cfg["kind"] in ("c1", "c3"):
        for i in range(int(cfg["kind"][1])):
            h = k2s2(params[f"conv{i}"], h)
    else:
        h = k2s2(params["stem"], h)
        for i in range(cfg["rb_blocks"]):
            blk = params[f"rb{i}"]
            y = dense(blk["expand"], h, relu=True)
            if i < n_stride2(cfg) - 1:
                y = k2s2(blk["mix"], y)
                skip = 0.5 * (h[:, 0::2] + h[:, 1::2])
            else:  # causal kernel 2, stride 1
                prev = torch.nn.functional.pad(y, (0, 0, 1, 0))[:, :-1]
                y = dense(blk["mix"], torch.cat([prev, y], dim=-1), relu=True)
                skip = h
            h = skip + dense(blk["project"], y)
    h = dense(params["fc0"], h.reshape(B, -1), relu=True)
    return dense(params["fc1"], h)


def decode(raw: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Hybrid decode: the argmax class (ties to the first), or the
    regression head (× 64, at least the last class) where it is the last."""
    k = cfg["n_classes"]
    r = raw.reshape(raw.shape[0], N_HEADS, k + 1)
    cls = torch.argmax(r[..., :k], dim=-1)
    reg = torch.relu(r[..., k]) / REG_SCALE
    return torch.where(cls == k - 1, torch.clamp(reg, min=float(k - 1)), cls.to(torch.float32))


class _Lanes:
    """The roll-layout state of a block of lanes (slot 0 = newest)."""

    def __init__(self, L: int, Q: int, dev):
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
        self.feat, self.addr = z(L, Q, STATIC), z(L, Q, N_ADDR, dt=torch.int32)
        self.resid, self.exec_lat, self.store_lat = z(L, Q), z(L, Q), z(L, Q)
        self.valid, self.in_mw, self.is_store = (z(L, Q, dt=torch.bool) for _ in range(3))
        self.tick, self.overflow = z(L, dt=torch.float64), z(L, dt=torch.int64)


def _suffix_count(x: torch.Tensor) -> torch.Tensor:
    """Per slot, how many set entries lie at higher slots (older)."""
    xi = x.to(torch.int32)
    return torch.flip(torch.cumsum(torch.flip(xi, [-1]), -1), [-1]) - xi


def _step(s: _Lanes, feat, addr, is_store, active, rw, ctx, params, cfg, sim, mm, raws=None):
    L, Q = s.valid.shape
    dep = (s.addr == addr[:, None, :]) & (addr[:, None, :] != 0)
    lat = [(p * LAT_SCALE)[..., None] for p in (s.resid, s.exec_lat, s.store_lat)]
    v = s.valid.float()[..., None]
    ctx_rows = torch.cat([s.feat, *lat, dep.float(), v], dim=-1) * v
    dev = feat.device
    cur = torch.cat([feat, torch.zeros((L, 8), device=dev), torch.ones((L, 1), device=dev)], -1)
    raw = predictor_raw(params, torch.cat([cur[:, None], ctx_rows], 1), cfg, mm)
    if raws is not None:
        raws.append(raw[active])
    lats = decode(raw, cfg)

    fetch = torch.clamp(torch.round(lats[:, 0]), 0, sim["max_latency"])
    exe = torch.clamp(torch.round(lats[:, 1]), 1, sim["max_latency"])
    sto = torch.where(is_store, torch.clamp(torch.round(lats[:, 2]), 1, sim["max_latency"]), 0.0)

    resid = s.resid + torch.where(s.valid, fetch[:, None], 0.0)
    budget = (rw.float() * torch.clamp(fetch, min=1.0)).to(torch.int32)
    proc = s.valid & ~s.in_mw
    ready = proc & (resid >= s.exec_lat)
    eligible = ready & (_suffix_count(proc & ~ready) == 0)
    retire = eligible & (_suffix_count(eligible) < budget[:, None])
    to_mw = retire & s.is_store
    in_mw = s.in_mw | to_mw
    valid = s.valid & ~(retire & ~to_mw)
    mw = valid & in_mw
    ready_m = mw & (resid >= s.store_lat)
    valid = valid & ~(ready_m & (_suffix_count(mw & ~ready_m) == 0))
    in_mw = in_mw & valid

    at_cap = torch.gather(valid, 1, (ctx - 1).long()[:, None])[:, 0]
    keep = torch.arange(Q, device=ctx.device)[None] < ctx[:, None]

    def push(buf, new):
        return torch.cat([new[:, None].to(buf.dtype), buf[:, :-1]], 1)

    a1 = active[:, None]
    a2 = active[:, None, None]
    s.feat = torch.where(a2, push(s.feat, feat), s.feat)
    s.addr = torch.where(a2, push(s.addr, addr), s.addr)
    s.resid = torch.where(a1, push(resid, torch.zeros_like(fetch)), s.resid)
    s.exec_lat = torch.where(a1, push(s.exec_lat, exe), s.exec_lat)
    s.store_lat = torch.where(a1, push(s.store_lat, sto), s.store_lat)
    s.valid = torch.where(a1, push(valid, torch.ones_like(active)) & keep, s.valid)
    s.in_mw = torch.where(a1, push(in_mw, torch.zeros_like(active)) & keep, s.in_mw)
    s.is_store = torch.where(a1, push(s.is_store, is_store), s.is_store)
    s.tick = s.tick + torch.where(active, fetch, 0.0).double()
    s.overflow = s.overflow + (at_cap & active).long()


def simulate(jobs: Sequence[dict], params, cfg: dict, sim: dict, device,
             precision: str = "f32", block_lanes: int = 8192, raws=None) -> List[dict]:
    """Per-job totals of ``jobs``. Each job is ``{"arrays": {"feat" (T,
    41) f32, "addr" (T, 5) i32, "is_store" (T,) bool}, "retire_width":
    int, "lanes": int}``; its T instructions split into ``lanes`` equal
    contiguous sub-traces (T % lanes == 0). ``params`` in the layout of
    `param_shapes`; ``cfg`` the predictor's configuration, ``sim`` the
    simulator's (``ctx_len``, ``max_latency``). Lanes run in blocks of at
    most ``block_lanes``. Returns ``[{"cycles": float, "overflow": int}]``,
    summed in float64 on the host; a list ``raws`` gets each step's raw
    head outputs of the active lanes."""
    dev = torch.device(device)
    lanes = []  # (job, first instruction, steps)
    for j, job in enumerate(jobs):
        T, n = len(job["arrays"]["feat"]), job["lanes"]
        if T % n:
            raise ValueError(f"job {j}: {T} instructions do not split into {n} lanes")
        lanes += [(j, k * (T // n), T // n) for k in range(n)]
    cycles = np.zeros(len(jobs), np.float64)
    overflow = np.zeros(len(jobs), np.int64)
    mm = _matmul(precision)
    with _plain_f32():
        for lo in range(0, len(lanes), block_lanes):
            blk = lanes[lo:lo + block_lanes]
            steps = max(n for _, _, n in blk)
            tot, ovf = _run_block(jobs, blk, steps, params, cfg, sim, dev, mm, raws)
            for (j, _, _), c, o in zip(blk, tot, ovf):
                cycles[j] += c
                overflow[j] += o
    return [{"cycles": float(c), "overflow": int(o)} for c, o in zip(cycles, overflow)]


def _run_block(jobs, blk, steps, params, cfg, sim, dev, mm, raws):
    L, Q = len(blk), sim["ctx_len"]
    feat = np.zeros((steps, L, STATIC), np.float32)
    addr = np.zeros((steps, L, N_ADDR), np.int32)
    is_store = np.zeros((steps, L), bool)
    active = np.zeros((steps, L), bool)
    for i, (j, first, n) in enumerate(blk):
        a = jobs[j]["arrays"]
        feat[:n, i] = a["feat"][first:first + n]
        addr[:n, i] = a["addr"][first:first + n]
        is_store[:n, i] = a["is_store"][first:first + n]
        active[:n, i] = True
    rw = torch.tensor([jobs[j]["retire_width"] for j, _, _ in blk], dtype=torch.int32, device=dev)
    ctx = torch.full((L,), Q, dtype=torch.int32, device=dev)
    xs = [torch.from_numpy(v).to(dev) for v in (feat, addr, is_store, active)]
    s = _Lanes(L, Q, dev)
    with torch.no_grad():
        for t in range(steps):
            _step(s, xs[0][t], xs[1][t], xs[2][t], xs[3][t], rw, ctx, params, cfg, sim, mm, raws)
        need = torch.where(s.valid, torch.maximum(s.exec_lat, s.store_lat) - s.resid, 0.0)
        drain = torch.clamp(need, min=0.0).amax(-1)
        return (s.tick + drain.double()).cpu().numpy(), s.overflow.cpu().numpy()


@contextlib.contextmanager
def _plain_f32():
    """Matrix products in full float32 (TF32 off), restored after."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved
