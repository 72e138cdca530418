"""Recurrent sequence mixers: RG-LRU (RecurrentGemma/Griffin) and RWKV6
(Finch) — the port of ``repro.nn.ssm``.

Both are linear recurrences with data-dependent diagonal decay, computed
in f32. Sequence mode (prefill) and decode mode (one token, O(1) state)
as in the reference. Two sequence forms differ in how they sum:
- the RG-LRU prefill is the reference's associative scan, done here by
  doubling (`_linear_scan`: log2 T rounds of elementwise work) where XLA
  uses its own tree, so the f32 sums are associated in another order;
- the RWKV6 prefill is a loop over time, as the reference's ``lax.scan``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn.init import ShardSpec, dense_init, scalar_init, split_keys
from repro_torch.nn.layers import (causal_conv1d, causal_conv1d_params, causal_conv1d_specs,
                                   causal_conv1d_step)

# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_params(generator, d_rnn, n_heads):
    """Block-diagonal input/recurrence gates + per-channel decay Λ."""
    kx, ka = split_keys(generator, 2)
    block = d_rnn // n_heads
    dev = generator.device

    def block_diag(g):
        w = dense_init(g, block, block * n_heads)
        return w.reshape(block, n_heads, block).permute(1, 0, 2).contiguous()  # (H, b, b)

    # softplus(Λ) ~ 0.1 → a ≈ exp(-0.8 r): decays in (0.45, 1.0)
    lam0 = math.log(math.expm1(0.1))
    return {
        "w_input_gate": block_diag(kx),  # used in f32
        "w_rec_gate": block_diag(ka),  # used in f32
        "b_input_gate": scalar_init(0.0, (d_rnn,), device=dev),
        "b_rec_gate": scalar_init(0.0, (d_rnn,), device=dev),
        "lam": scalar_init(lam0, (d_rnn,), device=dev),
    }


def rglru_specs():
    return {
        "w_input_gate": ShardSpec((None, None, "embed")),
        "w_rec_gate": ShardSpec((None, None, "embed")),
        "b_input_gate": ShardSpec(("embed",)),
        "b_rec_gate": ShardSpec(("embed",)),
        "lam": ShardSpec(("embed",)),
    }


def _rglru_gates(params, x, n_heads):
    """x: (..., d_rnn) -> (input_gate, rec_gate, log_a) each (..., d_rnn) f32.
    Heads that do not divide among the ranks splitting ``x`` are gathered
    first, and ``x`` is then cut into heads, and the gates' heads merged,
    on each rank's local tensor: their gradients come back split where
    the split cuts a head, which torch 2.11's DTensor refuses to regroup
    (``from_local``'s backward gathers them first)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.sharding import cuts_groups, whole_if_uneven

    shape = x.shape
    H = n_heads
    heads = shape[:-1] + (H, shape[-1] // H)
    uneven = cuts_groups(x, -1, H)
    x = whole_if_uneven(x, -1, H)

    def regrouped(t, to):  # t viewed as ``to``
        if not uneven:
            return t.reshape(to)
        local = t.to_local()
        return DTensor.from_local(local.reshape(local.shape[:len(shape) - 1] + to[len(shape) - 1:]),
                                  t.device_mesh, t.placements, shape=to, run_check=False,
                                  stride=tuple(math.prod(to[i + 1:]) for i in range(len(to))))

    xb = regrouped(x, heads).to(torch.float32)
    wi = params["w_input_gate"].to(torch.float32)
    wr = params["w_rec_gate"].to(torch.float32)
    gi = regrouped(torch.einsum("...hb,hbc->...hc", xb, wi), shape)
    gr = regrouped(torch.einsum("...hb,hbc->...hc", xb, wr), shape)
    i_gate = torch.sigmoid(gi + params["b_input_gate"].to(torch.float32))
    r_gate = torch.sigmoid(gr + params["b_rec_gate"].to(torch.float32))
    log_a = -RGLRU_C * F.softplus(params["lam"].to(torch.float32)) * r_gate
    return i_gate, r_gate, log_a


def _linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_{-1} = 0: the inclusive
    scan of the reference's combine ((a_l, b_l), (a_r, b_r)) ->
    (a_l a_r, a_r b_l + b_r), by doubling: after the round of stride d,
    entry t holds the combine of entries (t - 2d, t]."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru(params, x, h0=None, *, n_heads, dtype=torch.bfloat16):
    """Sequence-mode RG-LRU. x: (B, T, d_rnn). Returns (y in ``dtype``,
    h_last f32). f32 recurrence math."""
    i_gate, _, log_a = _rglru_gates(params, x, n_heads)
    a = torch.exp(log_a)  # (B, T, D) f32
    gated_x = x.to(torch.float32) * i_gate
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * gated_x
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(dtype), h[:, -1, :]


def rglru_step(params, x_t, h, *, n_heads, dtype=torch.bfloat16):
    """Single-token decode step. x_t: (B, d_rnn); h: (B, d_rnn) f32.
    Returns (y in ``dtype``, new h f32)."""
    i_gate, _, log_a = _rglru_gates(params, x_t, n_heads)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * (x_t.to(torch.float32) * i_gate)
    h_new = a * h + b
    return h_new.to(dtype), h_new


def recurrent_block_params(generator, d_model, d_rnn, n_heads, conv_width=4):
    kx, ky, kc, kr, ko = split_keys(generator, 5)
    return {
        "wx": dense_init(kx, d_model, d_rnn),
        "wy": dense_init(ky, d_model, d_rnn),
        "conv": causal_conv1d_params(kc, conv_width, d_rnn),
        "rglru": rglru_params(kr, d_rnn, n_heads),
        "wo": dense_init(ko, d_rnn, d_model),
    }


def recurrent_block_specs():
    return {
        "wx": ShardSpec(("embed", "mlp")),
        "wy": ShardSpec(("embed", "mlp")),
        "conv": causal_conv1d_specs(),
        "rglru": rglru_specs(),
        "wo": ShardSpec(("mlp", "embed")),
    }


class RecurrentState(NamedTuple):
    h: torch.Tensor  # (B, d_rnn) fp32 RG-LRU state
    conv: torch.Tensor  # (B, conv_width-1, d_rnn) conv lookback

    @staticmethod
    def zeros(batch, d_rnn, conv_width=4, dtype=torch.float32, device=None):
        return RecurrentState(
            torch.zeros((batch, d_rnn), dtype=dtype, device=device),
            torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype, device=device),
        )


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def recurrent_block(params, x, *, n_heads, dtype=torch.bfloat16, with_state=False):
    """Griffin recurrent block, sequence mode. x: (B, T, D) -> (B, T, D);
    with ``with_state`` also the decode state after the last token
    (RecurrentState: h f32, and the conv lookback, which carries the
    pre-conv branch inputs, in f32)."""
    x = x.to(dtype)
    pre = x @ params["wx"].to(dtype)  # the conv's input: what its lookback carries
    yb = _gelu(x @ params["wy"].to(dtype))
    xb = causal_conv1d(params["conv"], pre, dtype=dtype)
    h, h_last = rglru(params["rglru"], xb, n_heads=n_heads, dtype=dtype)
    y = (h * yb) @ params["wo"].to(dtype)
    if not with_state:
        return y
    width = params["conv"]["w"].shape[0]
    return y, RecurrentState(h_last, pre[:, -(width - 1):, :].to(torch.float32))


def recurrent_block_step(params, x_t, state: RecurrentState, *, n_heads, dtype=torch.bfloat16):
    """Decode step. x_t: (B, D). Returns (y, RecurrentState)."""
    x_t = x_t.to(dtype)
    xb = x_t @ params["wx"].to(dtype)
    yb = _gelu(x_t @ params["wy"].to(dtype))
    xb, conv_state = causal_conv1d_step(params["conv"], xb, state.conv.to(dtype), dtype=dtype)
    h_out, h_new = rglru_step(params["rglru"], xb, state.h, n_heads=n_heads, dtype=dtype)
    y = (h_out * yb) @ params["wo"].to(dtype)
    return y, RecurrentState(h_new, conv_state.to(torch.float32))


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

LORA_DIM = 32


def _lora_params(generator, d_model, out_dim, hidden=LORA_DIM):
    k1, k2 = split_keys(generator, 2)
    # used in f32 (`_lora`)
    return {"a": dense_init(k1, d_model, hidden), "b": dense_init(k2, hidden, out_dim, scale=0.1)}


def _lora(params, x):
    h = torch.tanh(x.to(torch.float32) @ params["a"].to(torch.float32))
    return h @ params["b"].to(torch.float32)


def rwkv_timemix_params(generator, d_model, n_heads):
    keys = split_keys(generator, 12)
    dev = generator.device
    p = {name: dense_init(keys[i], d_model, d_model)
         for i, name in enumerate(["wr", "wk", "wv", "wg", "wo"])}
    # token-shift data-dependent lerp factors (Finch ddlerp, simplified to
    # static mu + LoRA delta on the decay/receptance paths)
    for name in ["mu_r", "mu_k", "mu_v", "mu_g", "mu_w"]:
        p[name] = scalar_init(0.5, (d_model,), device=dev)
    p["w0"] = scalar_init(-6.0, (d_model,), device=dev)
    p["decay_lora"] = _lora_params(keys[5], d_model, d_model)
    p["u"] = scalar_init(0.0, (d_model,), device=dev)
    # per-head output groupnorm
    p["ln_g"] = scalar_init(1.0, (d_model,), device=dev)
    p["ln_b"] = scalar_init(0.0, (d_model,), device=dev)
    return p


def rwkv_timemix_specs():
    s = {name: ShardSpec(("embed", "heads")) for name in ["wr", "wk", "wv", "wg"]}
    s["wo"] = ShardSpec(("heads", "embed"))
    for name in ["mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0"]:
        s[name] = ShardSpec(("embed",))
    s["decay_lora"] = {"a": ShardSpec(("embed", None)), "b": ShardSpec((None, "embed"))}
    for name in ["u", "ln_g", "ln_b"]:
        s[name] = ShardSpec(("embed",))
    return s


def _headify(x, n_heads):
    *lead, D = x.shape
    return x.reshape(*lead, n_heads, D // n_heads)


def _group_norm(x, g, b, eps=1e-5):
    """Per-head layer norm. x: (..., H, hd) -> (..., H * hd) f32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    *lead, H, hd = x.shape
    return y.reshape(*lead, H * hd) * g.to(torch.float32) + b.to(torch.float32)


def _lerp(params, mu, x, x_prev, dtype):
    m = params[mu].to(torch.float32)
    return (x.to(torch.float32) * (1 - m) + x_prev.to(torch.float32) * m).to(dtype)


def _timemix_inputs(params, x, x_prev, dtype):
    """Token-shift lerps + projections. x, x_prev: (..., D)."""
    xr, xk, xv, xg, xw = (_lerp(params, m, x, x_prev, dtype)
                          for m in ["mu_r", "mu_k", "mu_v", "mu_g", "mu_w"])
    r = xr @ params["wr"].to(dtype)
    k = xk @ params["wk"].to(dtype)
    v = xv @ params["wv"].to(dtype)
    g = F.silu(xg @ params["wg"].to(dtype))
    # data-dependent decay (fp32): w = exp(-exp(w0 + lora(xw)))
    log_neg_log_w = params["w0"].to(torch.float32) + _lora(params["decay_lora"], xw)
    w = torch.exp(-torch.exp(log_neg_log_w))  # in (0, 1)
    return r, k, v, g, w


def _wkv_step(S, r_t, k_t, v_t, w_t, uh):
    """One step of the wkv recurrence, f32. S: (B, H, hd, hd); r/k/v/w_t:
    (B, H, hd); uh: (H, hd). Returns (y_t (B, H, hd), new S)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    y_t = torch.einsum("bhi,bhij->bhj", r_t, S + uh[None, :, :, None] * kv)
    return y_t, w_t[..., None] * S + kv


def _wkv_scan(rh, kh, vh, wh, uh, S):
    """The wkv recurrence along T of (B, T, H, hd) f32 r, k, v and w from
    state S: (y (B, T, H, hd), the last S). Each input is split along T
    once (the reference's ``moveaxis`` into ``lax.scan``), so the backward
    stacks each input's gradient once: O(T) bytes, where a select a step
    would scatter a full (B, T, H, hd) gradient a step. On DTensors each
    rank runs the steps on its local rows (`_wkv_scan_local`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(rh, DTensor):
        return _wkv_scan_local(rh, kh, vh, wh, uh, S)
    ys = []
    for r_t, k_t, v_t, w_t in zip(*(t.unbind(1) for t in (rh, kh, vh, wh))):
        y_t, S = _wkv_step(S, r_t, k_t, v_t, w_t, uh)
        ys.append(y_t)
    return torch.stack(ys, dim=1), S


def _wkv_scan_local(rh, kh, vh, wh, uh, S):
    """`_wkv_scan` of DTensors: batch rows and heads keep their split (the
    recurrence never mixes them), T and hd are gathered, and each rank
    steps its local tensors, so a long sequence costs T plain ops a rank
    instead of T DTensor dispatches. ``u`` is shared by the batch rows:
    its gradient is a partial sum over the mesh dims that split them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.runtime.sharding import place

    mesh = rh.device_mesh
    want = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in rh.placements]
    r, k, v, w = (place(t, mesh, want) for t in (rh, kh, vh, wh))
    rows = r.placements
    u = place(uh, mesh, [Shard(0) if p.is_shard(2) else Replicate() for p in rows])
    u_grad = [Partial() if p.is_shard(0) else q for p, q in zip(rows, u.placements)]
    s = place(S, mesh, [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate()
                        for p in rows])
    y, s_last = _wkv_scan(*(t.to_local() for t in (r, k, v, w)),
                          u.to_local(grad_placements=u_grad), s.to_local())
    return (DTensor.from_local(y, mesh, rows, run_check=False),
            DTensor.from_local(s_last, mesh, s.placements, run_check=False))


def rwkv_timemix(params, x, x_last, state0, *, n_heads, dtype=torch.bfloat16):
    """Sequence mode. x: (B, T, D); x_last: (B, D) previous-token carry;
    state0: (B, H, hd, hd) fp32 wkv state. Returns (y, x_last', state')."""
    B, T, D = x.shape
    x_prev = torch.cat([x_last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    r, k, v, g, w = _timemix_inputs(params, x, x_prev, dtype)
    rh, kh, vh = (_headify(t, n_heads).to(torch.float32) for t in (r, k, v))
    wh = _headify(w, n_heads)  # (B, T, H, hd) fp32
    uh = _headify(params["u"].to(torch.float32), n_heads)  # (H, hd)
    y, S = _wkv_scan(rh, kh, vh, wh, uh, state0.to(torch.float32))  # (B, T, H, hd) fp32
    y = _group_norm(y, params["ln_g"], params["ln_b"])
    y = (y * g.to(torch.float32).reshape(B, T, D)).to(dtype)
    return y @ params["wo"].to(dtype), x[:, -1, :], S


def rwkv_timemix_step(params, x_t, x_last, state, *, n_heads, dtype=torch.bfloat16):
    """Decode step. x_t: (B, D); state: (B, H, hd, hd) fp32.
    Returns (y, x_last', state')."""
    from torch.distributed.tensor import DTensor

    r, k, v, g, w = _timemix_inputs(params, x_t, x_last, dtype)
    rh, kh, vh = (_headify(t, n_heads).to(torch.float32) for t in (r, k, v))
    uh = _headify(params["u"].to(torch.float32), n_heads)
    wh = _headify(w, n_heads)
    if isinstance(rh, DTensor):  # each rank steps its local heads: torch 2.11's DTensor
        # refuses the step's einsum with the heads split (it flattens (B, H))
        y, state_new = _wkv_scan_local(*(t[:, None] for t in (rh, kh, vh, wh)), uh,
                                       state.to(torch.float32))
        y = y[:, 0]
    else:
        y, state_new = _wkv_step(state.to(torch.float32), rh, kh, vh, wh, uh)
    y = _group_norm(y, params["ln_g"], params["ln_b"])
    y = (y * g.to(torch.float32)).to(dtype)
    return y @ params["wo"].to(dtype), x_t, state_new


def rwkv_channelmix_params(generator, d_model, d_ff):
    kk, kv, kr = split_keys(generator, 3)
    dev = generator.device
    return {
        "wk": dense_init(kk, d_model, d_ff),
        "wv": dense_init(kv, d_ff, d_model),
        "wr": dense_init(kr, d_model, d_model),
        "mu_k": scalar_init(0.5, (d_model,), device=dev),
        "mu_r": scalar_init(0.5, (d_model,), device=dev),
    }


def rwkv_channelmix_specs():
    return {
        "wk": ShardSpec(("embed", "mlp")),
        "wv": ShardSpec(("mlp", "embed")),
        "wr": ShardSpec(("embed", "embed2")),
        "mu_k": ShardSpec(("embed",)),
        "mu_r": ShardSpec(("embed",)),
    }


def _channelmix(params, x, x_prev, dtype):
    xk, xr = _lerp(params, "mu_k", x, x_prev, dtype), _lerp(params, "mu_r", x, x_prev, dtype)
    k = torch.square(F.relu(xk @ params["wk"].to(dtype)))
    kv = k @ params["wv"].to(dtype)
    r = torch.sigmoid(xr @ params["wr"].to(dtype))
    return r * kv


def rwkv_channelmix(params, x, x_last, *, dtype=torch.bfloat16):
    """x: (B, T, D); x_last: (B, D). Returns (y, new x_last)."""
    x_prev = torch.cat([x_last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    return _channelmix(params, x, x_prev, dtype), x[:, -1, :]


def rwkv_channelmix_step(params, x_t, x_last, *, dtype=torch.bfloat16):
    return _channelmix(params, x_t, x_last, dtype), x_t
