"""Public wrappers of the port's CUDA kernels.

Same signatures and output shapes as the reference's ``repro.kernels.ops``
wrappers. For tensors on the CPU a wrapper computes the plain PyTorch
version (`kernels.ref`); for CUDA tensors it launches the hand-written
kernel on the current stream or raises — there is no fallback. Outputs are
allocated here with ``torch.empty``; the kernels allocate nothing.

``launches`` counts kernel launches per wrapper (plain integers, bumped
only where a kernel is launched), so a run can show that its main path
went through the kernels. Each wrapper call launches one kernel and
counts once. A CUDA graph's replay runs no Python, so each graph adds the
counts its capture recorded at every replay
(`serving.graphs.CapturedGraph`): the counts keep meaning the launches
the card ran.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.features import N_ADDR_KEYS, N_FEATURES, STATIC_END
from repro_torch.kernels import _build, ref
from repro_torch.runtime import opcount

launches = {"fused_step": 0, "cnn_trunk": 0, "conv2s": 0, "decode_attn": 0, "wkv_fwd": 0,
            "wkv_bwd": 0}
# conv widths (C1, C2, C3) the trunk kernels K1/K2 are compiled for
# (csrc/trunk_common.cuh): the C3 model's
TRUNK_WIDTHS = (64, 128, 128)
# K3 (csrc/conv2s.cu) holds W, its columns padded to 64, 128 or 256, in
# shared memory, or (Co % 4 == 0) a 32 KB ring of it, beside 512 bytes of
# mbarriers, the padded bias and a slot of at least one input row for each
# of its 8, 4 or 2 warp groups, within the 232,448 bytes an H100 block may
# opt into.
CONV2S_MAX_CO = 256
CONV2S_SMEM_BYTES = 232_448


_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _weight_ptrs(weights):
    """Device addresses of the weights and biases. The kernels copy the
    weights in 16-byte units (bulk copies, float4/float2 loads), so each
    must start 16-byte aligned (a fresh allocation does)."""
    flat = [t for wb in weights for t in wb]
    for t in flat:
        if t.data_ptr() % 16:
            raise ValueError("conv weights must be 16-byte aligned; pass a fresh .clone()")
    return [t.data_ptr() for t in flat]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a fresh copy if it does not start 16-byte aligned:
    the kernels read their inputs with 16-byte bulk copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _weights(layer_params: Sequence[dict]):
    if len(layer_params) != 3:
        raise ValueError(
            f"the trunk kernels fuse exactly the C3 depth (3 conv layers), got {len(layer_params)}"
        )
    return [(_f32(lp["w"]), _f32(lp["b"])) for lp in layer_params]


def _check_trunk_shapes(weights, c0: int, seq: int):
    (w1, b1), (w2, b2), (w3, b3) = weights
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    want = [(2 * c0, c1), (2 * c1, c2), (2 * c2, c3)]
    for i, ((w, b), shape) in enumerate(zip(weights, want)):
        if tuple(w.shape) != shape or tuple(b.shape) != (shape[1],):
            raise ValueError(f"conv{i} weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"do not chain from {c0} input channels")
    if seq % 8 or c0 % 2 or (c1, c2, c3) != TRUNK_WIDTHS:
        raise ValueError(f"kernel needs seq % 8 == 0, even input channels and the C3 widths "
                         f"{TRUNK_WIDTHS} it is built for; got seq={seq}, "
                         f"channels={(c0, c1, c2, c3)} (use_kernel=False takes any)")
    return c1, c2, c3


def _check_conv2s_widths(c: int, co: int) -> None:
    """Raise ValueError if K3 cannot hold a layer of these widths: more
    than CONV2S_MAX_CO output channels, or neither W (2C x Co, Co padded to
    64, 128 or 256) nor, where Co % 4 == 0, its 32 KB ring fitting in
    shared memory beside one input row for each warp group."""
    if co > CONV2S_MAX_CO:
        raise ValueError(f"conv2s kernel takes Co <= {CONV2S_MAX_CO} output channels, got {co}")
    np_ = next(n for n in (64, 128, 256) if co <= n)
    groups = 8 // (np_ // 64)
    w_floats = 2 * 4096 if co % 4 == 0 else 2 * c * np_
    need = 512 + 4 * (w_floats + np_ + groups * 2 * c)
    if need > CONV2S_SMEM_BYTES:
        held = "a 32 KB ring of W" if co % 4 == 0 else f"W (2C x {np_} floats)"
        raise ValueError(
            f"conv2s kernel holds {held}, the bias and one input row for each of its "
            f"{groups} warp groups in shared memory: {need} bytes for C={c}, Co={co}, past "
            f"the {CONV2S_SMEM_BYTES} a block may take")


def _cuda_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got one on {t.device}")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = _build.load(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launches[name] += 1
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def conv2s(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Fused k2s2 conv + bias + ReLU. x: (B, N, C) -> (B, N//2, Co), in
    f32 whatever the inputs' dtype (as the reference's wrapper)."""
    x = x.to(torch.float32)
    w, b = _f32(params["w"]), _f32(params["b"])
    if x.device.type == "cpu":
        return ref.conv2s_ref(x, w, b)
    dev = _cuda_device(x, w, b)
    B, N, C = x.shape
    co = w.shape[1]
    if tuple(w.shape) != (2 * C, co) or tuple(b.shape) != (co,):
        raise ValueError(f"conv weight {tuple(w.shape)} / bias {tuple(b.shape)} do not fit "
                         f"{C} input channels")
    if N % 2 or C % 2 or co % 2:
        raise ValueError(f"kernel needs N, C and Co even; got N={N}, C={C}, Co={co}")
    _check_conv2s_widths(C, co)
    x = _aligned(x.contiguous())
    out = torch.empty((B, N // 2, co), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _launch("conv2s", dev, x.data_ptr(), *_weight_ptrs([(w, b)]), out.data_ptr(), B, N, C, co,
            dev.index)
    return out


def cnn_trunk(layer_params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
    """Whole fused C3 trunk. x: (B, N, C) -> (B, N//8, C3), in f32 whatever
    x's dtype (as the reference's wrapper)."""
    weights = _weights(layer_params)
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return ref.cnn_trunk_ref(weights, x)
    dev = _cuda_device(x, *[t for wb in weights for t in wb])
    B, N, C = x.shape
    c1, c2, c3 = _check_trunk_shapes(weights, C, N)
    x = _aligned(_f32(x))
    out = torch.empty((B, N // 8, c3), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    ptrs = [x.data_ptr(), *_weight_ptrs(weights), out.data_ptr()]
    _launch("cnn_trunk", dev, *ptrs, B, N, C, c1, c2, c3)
    return out


def fused_step(layer_params: Sequence[dict], state, cur_feat: torch.Tensor,
               cur_addr: torch.Tensor, *, seq_padded: int) -> torch.Tensor:
    """Fused ring-state sim-step trunk: recency reorder + model-input
    assembly + the whole C3 conv stack in one kernel (the (L, 1+Q, 50)
    input never reaches device memory). ``state`` is a ring-layout
    `core.simulator.SimState` (only the queue planes and the global
    ``head`` cursor are read; the planes are taken in f32). Returns
    (L, seq_padded//8, C3)."""
    weights = _weights(layer_params)
    if cur_feat.device.type == "cpu":
        return ref.fused_step_ref(weights, state, cur_feat, cur_addr, seq_padded=seq_padded)
    L, Q, CF = state.feat.shape
    if CF != STATIC_END or tuple(state.addr.shape) != (L, Q, N_ADDR_KEYS):
        raise ValueError(f"state planes feat {tuple(state.feat.shape)} / addr "
                         f"{tuple(state.addr.shape)} are not (L, Q, {STATIC_END}) / "
                         f"(L, Q, {N_ADDR_KEYS})")
    if tuple(cur_feat.shape) != (L, STATIC_END) or tuple(cur_addr.shape) != (L, N_ADDR_KEYS):
        raise ValueError(f"cur_feat {tuple(cur_feat.shape)} / cur_addr "
                         f"{tuple(cur_addr.shape)} do not match {L} lanes")
    if seq_padded < Q + 1:
        raise ValueError(f"seq_padded={seq_padded} cannot hold 1 + {Q} rows")
    if Q % 4:
        raise ValueError(f"kernel copies each lane's planes in 16-byte units: ctx_len={Q} "
                         "must be a multiple of 4 (use_kernel=False takes any)")
    if state.valid.dtype != torch.bool or state.head.numel() != 1:
        raise ValueError("state.valid must be bool and state.head a scalar")
    c1, c2, c3 = _check_trunk_shapes(weights, N_FEATURES, seq_padded)
    planes = [
        _aligned(_f32(state.feat)),
        _aligned(state.addr.to(torch.int32).contiguous()),
        _aligned(_f32(state.resid)),
        _aligned(_f32(state.exec_lat)),
        _aligned(_f32(state.store_lat)),
        state.valid.contiguous(),
        state.head.to(torch.int32).contiguous(),
        _f32(cur_feat),
        cur_addr.to(torch.int32).contiguous(),
    ]
    dev = _cuda_device(*planes, *[t for wb in weights for t in wb])
    out = torch.empty((L, seq_padded // 8, c3), dtype=torch.float32, device=dev)
    if L == 0:
        return out
    ptrs = [p.data_ptr() for p in planes] + _weight_ptrs(weights) + [out.data_ptr()]
    _launch("fused_step", dev, *ptrs, L, Q, seq_padded, c1, c2, c3)
    return out


_DECODE_DTYPES = (torch.float32, torch.bfloat16)
_DECODE_HEAD_DIMS = (32, 64, 128, 256)
# K4's shared memory (csrc/decode_attn.cu): what a block may opt into on an
# H100, an SM's whole, and what the card keeps of it for each resident block
DECODE_SMEM_OPTIN = 232_448
_SM_SMEM, _BLOCK_RESERVED = 233_472, 1_024
_DECODE_MAX_STAGES, _DECODE_MAX_SPLITS = 8, 64


class DecodePlan(NamedTuple):
    """K4's launch: ``splits`` of the live range x (``row_groups`` blocks a
    kv head, ``rt`` 16-row tiles of query heads each) x kv heads x batch rows,
    ``threads`` a block (one producer warp and ``tile // 16`` consumer
    warps), a ring of ``stages`` stages of ``tile`` positions, and
    ``smem_bytes`` of dynamic shared memory, ``blocks_per_sm`` of which fit
    on an SM."""
    splits: int
    stages: int
    smem_bytes: int
    row_tiles: int
    rt: int
    row_groups: int
    tile: int
    threads: int
    blocks: int
    blocks_per_sm: int


def decode_plan(B: int, S: int, H: int, KV: int, hd: int, elem_bytes: int, n_sm: int,
                max_smem: int = DECODE_SMEM_OPTIN) -> DecodePlan:
    """K4's launch plan from the shapes and the SM count alone (no host
    sync: the live length is on the card). The layout is the kernel's
    (``decode_attn_smem_bytes`` there must agree):

    - a padded row is ``hd * elem_bytes + 16`` bytes; a stage holds ``tile``
      K rows and as many V rows, 64 positions, or 32 where a row is 512
      bytes or more;
    - the ``ceil(G / 16)`` row tiles of a group go to one block, or, past two
      tiles at hd <= 128 or one at hd 256 (the registers of the
      accumulators), to ``row_groups`` blocks that each read the K/V;
    - the most stages (3 to 8) that keep two blocks on an SM, else 3;
    - splits at least two stages long (a short cache gets one), and no more
      than the last block's merge holds in its ring at once (the group's
      rows x hd f32 a split); among the counts that give every SM a block,
      if any do, the one whose busiest SM has the least to do, a block
      counting as its share of S plus two stages (its start and its merge),
      then the fewest splits.
    """
    if hd not in _DECODE_HEAD_DIMS or H % KV or elem_bytes not in (2, 4):
        raise ValueError(f"decode_attn kernel takes head_dim in {_DECODE_HEAD_DIMS}, H a multiple "
                         f"of KV and bf16 or f32; got hd={hd}, H={H}, KV={KV}, {elem_bytes}-byte values")
    row = hd * elem_bytes + 16
    tile = 64 if hd * elem_bytes <= 256 else 32
    consumers = tile // 16
    threads = 32 * (consumers + 1)
    row_tiles = -(-(H // KV) // 16)
    row_groups = -(-row_tiles // (2 if hd <= 128 else 1))
    rt = -(-row_tiles // row_groups)
    p_bytes = consumers * 16 * 17 * 4 if elem_bytes == 4 else 0
    ring_offset = -(-(256 + rt * 16 * row + p_bytes) // 128) * 128
    rows = rt * 16  # the consumer warps' merge (merge_floats in the kernel)
    merge = 4 * consumers * rows * (hd + 6)

    def smem(stages):
        return ring_offset + max(stages * 2 * tile * row, merge)

    two = _SM_SMEM // 2 - _BLOCK_RESERVED
    stages = max([s for s in range(3, _DECODE_MAX_STAGES + 1) if smem(s) <= two], default=3)
    if smem(stages) > max_smem:
        raise ValueError(f"decode_attn kernel needs {smem(stages)} bytes of shared memory a block "
                         f"at hd={hd}, past the {max_smem} a block may take")
    blocks_per_sm = min(_SM_SMEM // (smem(stages) + _BLOCK_RESERVED), 2048 // threads)
    pairs = B * KV * row_groups
    # the splits' merge: weights of 64 splits a row, then the partials
    merge_room = stages * 2 * tile * row - -(-rows * (_DECODE_MAX_SPLITS * 12 + 4) // 16) * 16
    max_splits = max(1, min(_DECODE_MAX_SPLITS, S // (2 * tile),
                            merge_room // (min(rows, H // KV) * hd * 4)))
    counts = [s for s in range(1, max_splits + 1) if pairs * s >= n_sm] or range(1, max_splits + 1)
    splits = min(counts, key=lambda s: (-(-pairs * s // n_sm) * (S / s + 2 * tile), s))
    return DecodePlan(splits, stages, smem(stages), row_tiles, rt, row_groups, tile, threads,
                      splits * pairs, blocks_per_sm)


# Per (device, stream): K4's merge tickets, uint32 zeros that the kernel
# leaves at zero (the last block of each merge wraps its counter back). A
# call, a graph captured on a stream, and a graph's replays read the
# stream's buffer; a buffer outgrown is kept (a graph may hold it).
_tickets: dict = {}


def _decode_tickets(dev: torch.device, n: int) -> torch.Tensor:
    bufs = _tickets.setdefault((dev.index, torch.cuda.current_stream(dev).cuda_stream), [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attn's first call on a stream (or at a larger B x KV) "
                               "cannot be captured: call it once on the capture stream first")
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32, device=dev))
    return bufs[-1]


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_len, *,
                window: int = 0, offset: Optional[int] = None, return_lse: bool = False):
    """Flash-decode GQA. q: (B,H,hd); k,v: (B,S,KV,hd); cache_len: scalar
    int32 (a device tensor on the decode path; it is never read on the
    host), clamped to S as the reference's wrapper does. -> (B,H,hd) in q's
    dtype. On the card q, k and v share one dtype, f32 or bf16, and the
    kernel runs as one launch of `decode_plan`'s grid. A row with no live
    position is 0.

    Shard mode, for one rank's ``kvseq`` shard of a cache split along its
    sequence: ``offset`` (a Python int) is the global position of k's and
    v's first row; ``cache_len`` is then the global one (not clamped to
    S), from which the window is measured, and the shard may hold no live
    position. ``return_lse`` returns ``(out, lse)``: out in f32 and each
    row's log-sum-exp of its live logits, (B, H) f32 (-inf with none
    live), which the ranks merge (`repro_torch.nn.attention`)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        if offset is None:
            cache_len = torch.clamp(cache_len, max=S)
        got = ref.decode_attn_ref(q, k, v, cache_len, window=window, offset=offset,
                                  return_lse=return_lse)
        return got if return_lse else got.to(q.dtype)
    dev = _cuda_device(q, k, v)
    if cache_len.numel() != 1:
        raise ValueError(f"cache_len must be a scalar, got shape {tuple(cache_len.shape)}")
    if tuple(k.shape) != (B, S, KV, hd) or k.shape != v.shape or H % KV:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, hd), (B, S, KV, hd) x2 with H a multiple of KV")
    if q.dtype not in _DECODE_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes q, k, v of one dtype in {_DECODE_DTYPES}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _DECODE_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_DECODE_HEAD_DIMS}, got {hd}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel copies 16-byte units)")
    out = torch.empty((B, H, hd), dtype=torch.float32 if return_lse else q.dtype, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev) if return_lse else None
    if B == 0 or H == 0:
        return (out, lse) if return_lse else out
    props = torch.cuda.get_device_properties(dev)
    plan = decode_plan(B, S, H, KV, hd, q.element_size(), props.multi_processor_count,
                       getattr(props, "shared_memory_per_block_optin", 0) or DECODE_SMEM_OPTIN)
    tickets = _decode_tickets(dev, B * KV * plan.row_groups)
    part_ml = torch.empty((B, H, plan.splits, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, H, plan.splits, hd), dtype=torch.float32, device=dev)
    _launch("decode_attn", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, H, KV, hd,
            int(q.dtype == torch.bfloat16), int(window), 0 if offset is None else int(offset),
            S if offset is None else _INT32_MAX, plan.splits, plan.stages, plan.rt,
            plan.row_groups, plan.smem_bytes, dev.index)
    return (out, lse) if return_lse else out


WKV_HEAD_DIMS = (32, 64, 128)
# csrc/wkv.cu's kC: the forward saves the state before every WKV_CHUNK-th
# step for the backward, which recomputes the states in between
WKV_CHUNK = 16


def wkv_checkpoints_shape(B: int, T: int, H: int, hd: int) -> tuple:
    """The states the forward kernel saves for the backward: (B, H,
    ceil(T / WKV_CHUNK), hd, hd) f32 (at B 4, T 1024, H 32, hd 64: 134 MB)."""
    return (B, H, -(-T // WKV_CHUNK), hd, hd)


def _wkv_cuda_args(*tensors):
    dev = _cuda_device(*tensors)
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("wkv's tensors must start 16-byte aligned (the kernels copy 16-byte "
                             "units)")
    return dev


@torch.library.custom_op("repro_torch::wkv", mutates_args=(),
                         schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0, "
                                "bool save) -> (Tensor, Tensor, Tensor)")
def _wkv_op(r, k, v, w, u, s0, save):
    """(y, last S, the saved states or an empty tensor): `wkv`'s one op."""
    if r.device.type == "cpu":
        y, s = ref.wkv_ref(r, k, v, w, u, s0)
        return y, s, r.new_empty(0)
    B, T, H, hd = r.shape
    dev = _wkv_cuda_args(r, k, v, w, u, s0)
    y, s_out = torch.empty_like(r), torch.empty_like(s0)
    ckpt = torch.empty(wkv_checkpoints_shape(B, T, H, hd) if save else (0,), dtype=torch.float32,
                       device=dev)
    _launch("wkv_fwd", dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), ckpt.data_ptr() if save else None,
            B, T, H, hd, dev.index)
    return y, s_out, ckpt


@_wkv_op.register_fake
def _(r, k, v, w, u, s0, save):
    B, T, H, hd = r.shape
    ckpt = r.new_empty(wkv_checkpoints_shape(B, T, H, hd) if save else (0,))
    return torch.empty_like(r), torch.empty_like(s0), ckpt


@torch.library.custom_op("repro_torch::wkv_bwd", mutates_args=(),
                         schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0, "
                                "Tensor ckpt, Tensor gy, Tensor? gs) -> (Tensor, Tensor, Tensor, "
                                "Tensor, Tensor, Tensor)")
def _wkv_bwd_op(r, k, v, w, u, s0, ckpt, gy, gs):
    """(gr, gk, gv, gw, gu, gS0) from the forward's inputs, its saved
    states, gy and g(S_T) (None: zeros): the backward kernel's one op. On
    the CPU the gradient is the plain loop's autograd (`_wkv_backward`)."""
    if r.device.type == "cpu":
        raise ValueError("wkv_bwd launches the CUDA kernel; on the CPU the plain loop's autograd "
                         "gives wkv's gradient")
    B, T, H, hd = r.shape
    if tuple(ckpt.shape) != wkv_checkpoints_shape(B, T, H, hd):
        raise ValueError(f"wkv_bwd needs the forward's saved states "
                         f"{wkv_checkpoints_shape(B, T, H, hd)}, got {tuple(ckpt.shape)}")
    gy = gy.contiguous()
    gs = None if gs is None else gs.contiguous()
    dev = _wkv_cuda_args(r, k, v, w, u, ckpt, gy, *([] if gs is None else [gs]))
    gr, gk, gv, gw = (torch.empty_like(r) for _ in range(4))
    gu_part = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    gs0 = torch.empty_like(s0)
    _launch("wkv_bwd", dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            ckpt.data_ptr(), gy.data_ptr(), None if gs is None else gs.data_ptr(), gr.data_ptr(),
            gk.data_ptr(), gv.data_ptr(), gw.data_ptr(), gu_part.data_ptr(), gs0.data_ptr(),
            B, T, H, hd, dev.index)
    return gr, gk, gv, gw, gu_part.sum(0), gs0


@_wkv_bwd_op.register_fake
def _(r, k, v, w, u, s0, ckpt, gy, gs):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u), torch.empty_like(s0))


def _wkv_setup(ctx, inputs, output):
    r, k, v, w, u, s0, _ = inputs
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)  # no zeros of the saved states' size for their gradient
    ctx.save_for_backward(r, k, v, w, u, s0, output[2])


def _wkv_backward(ctx, gy, gs, _):
    from torch._subclasses.fake_tensor import is_fake

    r, k, v, w, u, s0, ckpt = ctx.saved_tensors
    gy = torch.zeros_like(r) if gy is None else gy
    work = lambda: opcount.wkv_work(r, k, v, w, u, s0,  # noqa: E731
                                    states=ckpt.numel() * ckpt.element_size(), backward=True)
    with opcount.region("wkv", work):
        if r.device.type == "cpu" and not is_fake(r):
            # the plain loop's own autograd (its bits, its O(T) backward),
            # on the forward taken again
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
                y, s = ref.wkv_ref(*ins)
                pairs = [(y, gy)] + ([] if gs is None else [(s, gs)])
                got = torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs])
        else:
            got = _wkv_bwd_op(r, k, v, w, u, s0, ckpt, gy, gs)
    return (*got, None)


torch.library.register_autograd("repro_torch::wkv", _wkv_backward, setup_context=_wkv_setup)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
        s0: torch.Tensor):
    """rwkv6's wkv recurrence (`ref.wkv_ref`): r, k, v, w (B, T, H, hd), u
    (H, hd) and the state s0 (B, H, hd, hd), all f32 and contiguous ->
    (y (B, T, H, hd), the last state). One dispatcher op
    (``repro_torch::wkv``) whatever T is, with its autograd: on CPU tensors
    the plain loop (its backward the loop's autograd), on CUDA tensors the
    forward kernel (``launches["wkv_fwd"]``; it also saves the state every
    WKV_CHUNK steps when a gradient may be asked) and the backward kernel
    (``launches["wkv_bwd"]``), hd 32, 64 or 128; fake tensors trace it as
    one op. Counted as one ``"wkv"`` region (`runtime.opcount.wkv_work`),
    its backward as another. The regions open here, not in the callers as
    K1-K4's do, because only the op's autograd function sees the
    backward."""
    B, T, H, hd = r.shape
    for name, t, shape in (("r", r, (B, T, H, hd)), ("k", k, (B, T, H, hd)),
                           ("v", v, (B, T, H, hd)), ("w", w, (B, T, H, hd)), ("u", u, (H, hd)),
                           ("s0", s0, (B, H, hd, hd))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"wkv takes f32 contiguous r, k, v, w {(B, T, H, hd)}, u {(H, hd)} "
                             f"and s0 {(B, H, hd, hd)}; got {name} {tuple(t.shape)} {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    if T == 0:
        raise ValueError("wkv needs at least one step")
    if r.device.type == "cuda" and hd not in WKV_HEAD_DIMS:
        raise ValueError(f"wkv kernels take head_dim in {WKV_HEAD_DIMS}, got {hd}")
    ts = (r, k, v, w, u, s0)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    states = 4 * math.prod(wkv_checkpoints_shape(B, T, H, hd)) if save else 0
    work = lambda: opcount.wkv_work(*ts, states=states)  # noqa: E731
    with opcount.region("wkv", work):
        y, s, _ = _wkv_op(*ts, save)
    return y, s
