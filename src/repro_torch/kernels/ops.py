"""Public wrappers of the port's CUDA kernels.

Same signatures and output shapes as the reference's ``repro.kernels.ops``
wrappers. For tensors on the CPU a wrapper computes the plain PyTorch
version (`kernels.ref`); for CUDA tensors it launches the hand-written
kernel on the current stream or raises — there is no fallback. Outputs are
allocated here with ``torch.empty``; the kernels allocate nothing.

``launches`` counts kernel launches per wrapper (plain integers, bumped
only where a kernel is launched), so a run can show that its main path
went through the kernels. A wrapper call counts once, even where it
launches two kernels (``decode_attn``: the split pass and its combine).
A CUDA graph's replay runs no Python, so each graph adds the counts its
capture recorded at every replay (`serving.graphs.CapturedGraph`): the
counts keep meaning the launches the card ran.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.features import N_ADDR_KEYS, N_FEATURES, STATIC_END
from repro_torch.kernels import _build, ref

launches = {"fused_step": 0, "cnn_trunk": 0, "conv2s": 0, "decode_attn": 0}
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


def _decode_splits(dev: torch.device, B: int, KV: int, S: int) -> int:
    """Splits of the KV length: enough (batch row, kv head, split) blocks to
    put about four on each SM, but no split shorter than 64 positions."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-4 * sms // (B * KV)), -(-S // 64)))


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_len, *,
                window: int = 0) -> torch.Tensor:
    """Flash-decode GQA. q: (B,H,hd); k,v: (B,S,KV,hd); cache_len: scalar
    int32 (a device tensor on the decode path; it is never read on the
    host), clamped to S as the reference's wrapper does. -> (B,H,hd) in q's
    dtype. On the card q, k and v share one dtype, f32 or bf16. At least
    one position must be live (the decode path's cache_len is pos + 1 >= 1):
    with none, the kernel returns zeros where the plain version averages
    every v row."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        clamped = torch.clamp(cache_len, max=S)
        return ref.decode_attn_ref(q, k, v, clamped, window=window).to(q.dtype)
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
            raise ValueError(f"{name} must start 16-byte aligned (the kernel loads 16 bytes a lane)")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or H == 0:
        return out
    n_splits = _decode_splits(dev, B, KV, S)
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, hd), dtype=torch.float32, device=dev)
    _launch("decode_attn", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, int(q.dtype == torch.bfloat16), int(window), n_splits)
    return out
