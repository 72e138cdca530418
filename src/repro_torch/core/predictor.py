"""SimNet latency predictors in PyTorch (paper §2.3, Table 4) — the port of
``repro.core.predictor``.

Models over input (B, N, 50) with N = 1 + ctx_len (current + context):

  fc2/fc3   flattened MLPs (the paper's weak baselines)
  c1/c3     1-D CNNs: kernel=2 stride=2, non-overlapping hierarchical
            convolutions (a k2s2 conv is a reshape + one GEMM), + 2 FC layers
  rb7       7 residual blocks (EfficientNet-flavoured), the accuracy champion
  lstm2     2-layer LSTM over the instruction sequence
  tx6       6-layer transformer encoder
  ithemal_lstm2  the Ithemal-style baseline: the same LSTM, fed a fixed
            window of previous instructions instead of managed context

Output heads: hybrid = per-latency 10-way classification (cycles 0..8 +
overflow) + regression fallback; reg = regression only.

Parameters are nested dicts of tensors with the reference's layout
(``{"conv0": {"w": (2C, Co), "b": (Co,)}, ..., "rb0": {"expand": {...}},
"lstm0": {"wx", "wh", "b"}, "tx0": {"wqkv", ..., "ln1_g"}, "fc1": ...}``),
so weights cross between the packages through `params_from_numpy`.

Only c1/c3 reach the hand-written kernels (``use_kernel``); the other kinds
run plain PyTorch in f32 whatever ``compute_dtype`` is, as the reference's.
The LSTM runs as one call of ``torch.lstm`` over both layers (cuDNN on the
card, so a sim step's graph holds a few nodes for it, not 2 x 65 steps of
cells); `lstm_cells` is its plain step-by-step version.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.features import N_FEATURES
from repro_torch.core.simulator import torch_dtype
from repro_torch.runtime import opcount

N_HEADS = 3  # fetch, execution, store
REG_SCALE = 1.0 / 64.0  # regression head works in scaled-cycle space


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    kind: str = "c3"
    ctx_len: int = 64
    n_classes: int = 10
    output: str = "hybrid"  # hybrid | reg
    channels: Tuple[int, ...] = (64, 128, 128)  # conv channels (c*/rb*)
    hidden: int = 256  # FC head width
    lstm_hidden: int = 128
    tx_dim: int = 64
    tx_heads: int = 4
    tx_layers: int = 6
    rb_blocks: int = 7
    compute_dtype: str = "float32"  # "bfloat16": halve trunk activation
    # traffic (c1/c3 path; heads stay fp32 — hybrid decode is exact)

    @property
    def seq_in(self) -> int:
        return self.ctx_len + 1

    @property
    def n_stride2(self) -> int:
        if self.kind.startswith("c"):
            return len(self.channels[: int(self.kind[1])])
        if self.kind.startswith("rb"):
            return min(4, self.rb_blocks)
        return 0

    @property
    def seq_padded(self) -> int:
        m = 1 << max(self.n_stride2, 0)
        return ((self.seq_in + m - 1) // m) * m

    @property
    def out_dim(self) -> int:
        if self.output == "hybrid":
            return N_HEADS * (self.n_classes + 1)
        return N_HEADS


def _dense_shapes(d_in, d_out):
    return {"w": (d_in, d_out), "b": (d_out,)}


def param_shapes(cfg: PredictorConfig) -> dict:
    """The params tree of ``cfg.kind`` with a shape at every leaf, in the
    reference's layer order. An unknown kind raises ``ValueError``."""
    kind = cfg.kind
    if kind in ("fc2", "fc3"):
        depth = int(kind[2])
        dims = [cfg.seq_in * N_FEATURES] + [cfg.hidden * 2] * (depth - 1) + [cfg.out_dim]
        return {f"fc{i}": _dense_shapes(dims[i], dims[i + 1]) for i in range(depth)}
    if kind in ("c1", "c3"):
        depth = int(kind[1])
        chans = [N_FEATURES] + list(cfg.channels[:depth])
        shapes = {f"conv{i}": _dense_shapes(2 * chans[i], chans[i + 1]) for i in range(depth)}
        d_trunk = (cfg.seq_padded >> depth) * chans[-1]
    elif kind.startswith("rb"):
        c = cfg.channels[-1]
        shapes = {"stem": _dense_shapes(2 * N_FEATURES, c)}  # k2s2 stem
        for i in range(cfg.rb_blocks):
            shapes[f"rb{i}"] = {"expand": _dense_shapes(c, 2 * c),
                                "mix": _dense_shapes(4 * c, 2 * c),  # k2 conv of 2c channels
                                "project": _dense_shapes(2 * c, c)}
        d_trunk = (cfg.seq_padded >> cfg.n_stride2) * c
    elif kind in ("lstm2", "ithemal_lstm2"):
        h = cfg.lstm_hidden
        shapes = {f"lstm{l}": {"wx": (d_in, 4 * h), "wh": (h, 4 * h), "b": (4 * h,)}
                  for l, d_in in enumerate((N_FEATURES, h))}
        d_trunk = h
    elif kind == "tx6":
        d = cfg.tx_dim
        shapes = {"proj": _dense_shapes(N_FEATURES, d)}
        for l in range(cfg.tx_layers):
            shapes[f"tx{l}"] = {"wqkv": (d, 3 * d), "wo": (d, d), "ff1": _dense_shapes(d, 2 * d),
                                "ff2": _dense_shapes(2 * d, d), "ln1_g": (d,), "ln2_g": (d,)}
        d_trunk = d
    else:
        raise ValueError(kind)
    shapes["fc0"] = _dense_shapes(d_trunk, cfg.hidden)
    shapes["fc1"] = _dense_shapes(cfg.hidden, cfg.out_dim)
    return shapes


def _map_leaves(fn, shapes, path=()):
    """``{name: fn(path, shape)}`` over the nested shape tree."""
    return {k: _map_leaves(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_predictor(generator: torch.Generator, cfg: PredictorConfig,
                   device: DeviceLike = None) -> dict:
    """Fan-in scaled truncated-normal weights (2-sigma, as the reference's
    ``dense_init``), zero biases and unit norm gains, the weights drawn
    from ``generator`` in layer order. The generator must be a CPU
    generator, so the same seed gives the same weights on every device."""
    dev = resolve_device(device)

    def leaf(path, shape):
        name = path[-1]
        if name == "b":
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        if name.endswith("_g"):  # RMS-norm gain
            return torch.ones(shape, dtype=torch.float32, device=dev)
        std = 1.0 / math.sqrt(shape[0])
        w = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        return w.to(dev)

    return _map_leaves(leaf, param_shapes(cfg))


def params_from_numpy(tree, pcfg: PredictorConfig, device: DeviceLike = None) -> dict:
    """The reference's params (a nested dict of arrays, as its
    ``init_predictor`` or ``PredictorArtifact`` give them) as the port's
    params on ``device``. Every leaf's shape is checked against ``pcfg``."""
    dev = resolve_device(device)

    def leaf(path, shape):
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise ValueError(f"params lack {'.'.join(path)!r} for kind {pcfg.kind!r}")
            node = node[k]
        a = np.asarray(node, dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{'.'.join(path)} has shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.copy()).to(dev)

    return _map_leaves(leaf, param_shapes(pcfg))


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _pad_seq(x, cfg: PredictorConfig):
    pad = cfg.seq_padded - x.shape[1]
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x


def conv2s(params, x):
    """Non-overlapping k2s2 conv + bias + ReLU as reshaped matmul.
    x: (B, N, C) -> (B, N/2, C_out)."""
    B, N, C = x.shape
    xr = x.reshape(B, N // 2, 2 * C)
    return torch.relu(xr @ params["w"] + params["b"])


def _dense(params, x, act=None):
    y = x @ params["w"] + params["b"]
    return torch.relu(y) if act == "relu" else y


def _rms(x, g):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * g


def lstm_cells(params, x, cfg: PredictorConfig):
    """The two LSTM layers over ``x`` (B, N, F) step by step, as the
    reference's scan of cells: the newest row last, zero f32 state, gates
    split i, f, g, o. Returns the second layer's last hidden state (B, H).
    The plain version of `lstm_stack`."""
    B = x.shape[0]
    seq = torch.flip(x, dims=(1,)).transpose(0, 1)  # (N, B, F), newest last
    for l in range(2):
        lp = params[f"lstm{l}"]
        h = c = x.new_zeros((B, cfg.lstm_hidden), dtype=torch.float32)
        hs = []
        for x_t in seq:
            z = x_t @ lp["wx"] + h @ lp["wh"] + lp["b"]
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        seq = torch.stack(hs)
    return seq[-1]


def lstm_stack(params, x, cfg: PredictorConfig):
    """`lstm_cells` as ONE call of ``torch.lstm`` over both layers (cuDNN on
    the card; ATen's loop on the CPU). PyTorch's gate order is the
    reference's (i, f, g, o); its layer computes ``x W_ih^T + b_ih + h
    W_hh^T + b_hh``, so ``W_ih = wx^T``, ``W_hh = wh^T``, ``b_ih = b`` and
    ``b_hh = 0``. On the card this path is cuDNN or nothing: with cuDNN
    unavailable or disabled it raises rather than run ATen's per-step
    kernels unannounced."""
    if x.is_cuda and not (torch.backends.cudnn.is_available() and torch.backends.cudnn.enabled):
        raise RuntimeError("lstm on the card runs through cuDNN, which is unavailable or disabled")
    flat = []
    for l in range(2):
        lp = params[f"lstm{l}"]
        flat += [lp["wx"].t().contiguous(), lp["wh"].t().contiguous(), lp["b"],
                 torch.zeros_like(lp["b"])]
    seq = torch.flip(x, dims=(1,))  # newest row last
    h0 = x.new_zeros((2, x.shape[0], cfg.lstm_hidden), dtype=torch.float32)
    # cuDNN's training mode (kept state for the backward) only where a
    # gradient is wanted: a simulation step runs the inference mode, under
    # a graph or eagerly alike
    train = torch.is_grad_enabled() and any(t.requires_grad for t in [x] + flat)
    with warnings.catch_warnings():
        # cuDNN packs the separate weight tensors into its own buffer at
        # every call (its warning says so); the reference's (in, out)
        # layout is kept as the one source of the weights
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        out, _, _ = torch.lstm(seq, (h0, h0), flat, True, 2, 0.0, train, False, True)
    return out[:, -1]


def conv_stack(params, x, cfg: PredictorConfig, use_kernel: bool = False):
    """The c1/c3 k2s2 conv stack on ``x`` (B, N, 50) in the compute dtype:
    padded to ``seq_padded``, then `kernels.ops.cnn_trunk` (K2, f32) with
    ``use_kernel``, else one `conv2s` a layer. Returns (B, N'·C) f32. One
    `runtime.opcount.region` whichever runs: its count is the GEMMs' work."""
    convs = [params[f"conv{i}"] for i in range(int(cfg.kind[1]))]
    work = lambda: opcount.trunk_work(x, convs, cfg.seq_padded)  # noqa: E731
    with opcount.region("cnn_trunk", work):
        h = _pad_seq(x, cfg)
        if use_kernel:
            from repro_torch.kernels import ops as kops

            h = kops.cnn_trunk(convs, h)
        else:
            cdt = x.dtype
            for lp in convs:
                h = conv2s({"w": lp["w"].to(cdt), "b": lp["b"].to(cdt)}, h)
    return h.reshape(h.shape[0], -1).to(torch.float32)


def apply_trunk(params, x, cfg: PredictorConfig, use_kernel: bool = False):
    """(B, N, 50) -> (B, hidden) features before the output head.

    With ``use_kernel`` the c1/c3 conv stack runs in
    `kernels.ops.cnn_trunk`, which computes in f32 whatever
    ``compute_dtype`` is (as the reference's kernel wrapper does); the
    unfused path honours it. Other kinds ignore ``use_kernel`` and round
    their input through ``compute_dtype``, then compute in f32."""
    kind = cfg.kind
    cdt = torch_dtype(cfg.compute_dtype)
    x = x.to(cdt)
    if kind not in ("c1", "c3"):
        x = x.to(torch.float32)  # the bf16 path is the CNN trunk's alone
    if kind in ("fc2", "fc3"):
        depth = int(kind[2])
        h = x.reshape(x.shape[0], -1)
        for i in range(depth - 1):
            h = _dense(params[f"fc{i}"], h, act="relu")
        return h, params[f"fc{depth - 1}"]
    if kind in ("c1", "c3"):
        h = conv_stack(params, x, cfg, use_kernel=use_kernel)
    elif kind.startswith("rb"):
        h = conv2s(params["stem"], _pad_seq(x, cfg))  # plain, never the K3 kernel
        for i in range(cfg.rb_blocks):
            blk = params[f"rb{i}"]
            y = _dense(blk["expand"], h, act="relu")
            if i < cfg.n_stride2 - 1:  # static structure: the stem did one stride 2
                y = conv2s(blk["mix"], y)
                skip = 0.5 * (h[:, 0::2] + h[:, 1::2])  # avg-pool shortcut
            else:  # causal k2 s1: each row beside the row before it
                yp = torch.nn.functional.pad(y, (0, 0, 1, 0))
                y = torch.relu(torch.cat([yp[:, :-1], y], dim=-1) @ blk["mix"]["w"]
                               + blk["mix"]["b"])
                skip = h
            h = skip + _dense(blk["project"], y)
        h = h.reshape(h.shape[0], -1)
    elif kind in ("lstm2", "ithemal_lstm2"):
        h = lstm_stack(params, x, cfg)
    elif kind == "tx6":
        d, nh = cfg.tx_dim, cfg.tx_heads
        h = _dense(params["proj"], x)
        B, N, _ = h.shape
        for l in range(cfg.tx_layers):
            blk = params[f"tx{l}"]
            qkv = (_rms(h, blk["ln1_g"]) @ blk["wqkv"]).reshape(B, N, 3, nh, d // nh)
            q, k, v = qkv.unbind(2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d / nh)
            probs = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, N, d)
            h = h + ctx @ blk["wo"]
            h = h + _dense(blk["ff2"], torch.relu(_dense(blk["ff1"], _rms(h, blk["ln2_g"]))))
        h = h.mean(dim=1)
    else:
        raise ValueError(kind)
    return _dense(params["fc0"], h, act="relu"), params["fc1"]


# repro-lint: scan-reachable — called from the per-step body
def apply_raw(params, x, cfg: PredictorConfig, use_kernel: bool = False):
    """(B, N, 50) -> raw head outputs (B, out_dim)."""
    h, head = apply_trunk(params, x, cfg, use_kernel=use_kernel)
    return _dense(head, h)


def split_heads(raw, cfg: PredictorConfig):
    """-> (cls_logits (B, 3, n_classes) or None, reg (B, 3))."""
    B = raw.shape[0]
    if cfg.output == "hybrid":
        r = raw.reshape(B, N_HEADS, cfg.n_classes + 1)
        return r[..., : cfg.n_classes], r[..., cfg.n_classes]
    return None, raw


# repro-lint: scan-reachable — called from the per-step body
def decode_latency(raw, cfg: PredictorConfig):
    """Hybrid decode (paper §2.3): argmax class if < overflow else regression.
    Returns (B, 3) float latencies (regression head is in REG_SCALE space).
    ``torch.argmax`` breaks ties to the first maximum, as ``jnp.argmax``."""
    cls_logits, reg = split_heads(raw, cfg)
    reg = torch.relu(reg) / REG_SCALE
    if cls_logits is None:
        return reg
    cls = torch.argmax(cls_logits, dim=-1)
    overflow = cls == (cfg.n_classes - 1)
    return torch.where(overflow, torch.clamp(reg, min=float(cfg.n_classes - 1)),
                       cls.to(torch.float32))


def make_predict_fn(params, cfg: PredictorConfig, use_kernel: bool = False):
    def predict(x):
        raw = apply_raw(params, x, cfg, use_kernel=use_kernel)
        return decode_latency(raw, cfg)

    return predict


def fused_step_region(params, cfg: PredictorConfig, state, cur_feat, cur_addr):
    """The `runtime.opcount.region` of one c3 predictor step off the ring
    state (`runtime.opcount.fused_step_work`: K1's assembly and trunk, and
    the FC head), whichever route runs it: `make_fused_predict_fn`, or the
    plain route's `model_input` and predictor in
    `serving.simnet_engine.run_chunk`."""
    work = lambda: opcount.fused_step_work(params, state, cur_feat, cur_addr,  # noqa: E731
                                           cfg.seq_padded)
    return opcount.region("fused_step", work)


def make_fused_predict_fn(params, cfg: PredictorConfig):
    """Fused ring-state predictor: model-input assembly + the C3 conv
    trunk run in ONE kernel (`kernels.ops.fused_step`) straight off the
    ring-buffer SimState — the (L, 1+Q, 50) input never reaches device
    memory. The FC head + hybrid decode stay in plain torch.

    Signature matches `make_sim_scan`'s ``predict_state_fn``:
    (state, cur_feat, cur_addr) -> (L, 3) latencies. Requires the ring
    layout, kind == "c3", and an f32 state (the kernel assembles in f32;
    the engine sends a bf16 state to the unfused kernel path). The step
    is one `fused_step_region`.
    """
    if cfg.kind != "c3":
        raise ValueError(
            f"fused_step fuses the C3 trunk; got kind={cfg.kind!r} "
            "(use the unfused use_kernel path for other models)"
        )
    from repro_torch.kernels import ops as kops

    conv = [params[f"conv{i}"] for i in range(3)]

    def predict(state, cur_feat, cur_addr):
        with fused_step_region(params, cfg, state, cur_feat, cur_addr):
            h = kops.fused_step(conv, state, cur_feat, cur_addr, seq_padded=cfg.seq_padded)
            h = h.reshape(h.shape[0], -1).to(torch.float32)
            h = _dense(params["fc0"], h, act="relu")
            raw = _dense(params["fc1"], h)
            return decode_latency(raw, cfg)

    return predict


# ---------------------------------------------------------------------------
# computation intensity (Table 4's "MFlops per inference")
# ---------------------------------------------------------------------------

def inference_mflops(cfg: PredictorConfig) -> float:
    N, Fdim = cfg.seq_padded, N_FEATURES
    total = 0.0
    kind = cfg.kind
    if kind in ("fc2", "fc3"):
        depth = int(kind[2])
        dims = [cfg.seq_in * Fdim] + [cfg.hidden * 2] * (depth - 1) + [cfg.out_dim]
        for i in range(depth):
            total += dims[i] * dims[i + 1]
    elif kind in ("c1", "c3"):
        depth = int(kind[1])
        chans = [Fdim] + list(cfg.channels[:depth])
        n = N
        for i in range(depth):
            n //= 2
            total += n * 2 * chans[i] * chans[i + 1]
        total += (n * chans[-1]) * cfg.hidden + cfg.hidden * cfg.out_dim
    elif kind.startswith("rb"):
        c = cfg.channels[-1]
        n = N // 2
        total += (N // 2) * 2 * Fdim * c
        for i in range(cfg.rb_blocks):
            stride2 = i < cfg.n_stride2 - 1
            total += n * c * 2 * c  # expand
            if stride2:
                total += (n // 2) * (4 * c) * (2 * c)
                n //= 2
            else:
                total += n * (4 * c) * (2 * c)
            total += n * 2 * c * c  # project
        total += n * c * cfg.hidden + cfg.hidden * cfg.out_dim
    elif kind in ("lstm2", "ithemal_lstm2"):
        h = cfg.lstm_hidden
        total += cfg.seq_in * (Fdim * 4 * h + h * 4 * h)
        total += cfg.seq_in * (h * 4 * h + h * 4 * h)
        total += h * cfg.hidden + cfg.hidden * cfg.out_dim
    elif kind == "tx6":
        d = cfg.tx_dim
        n = cfg.seq_in
        per = n * (3 * d * d) + 2 * n * n * d + n * d * d + n * (4 * d * d)
        total += cfg.tx_layers * per + Fdim * d * n + d * cfg.hidden + cfg.hidden * cfg.out_dim
    return total / 1e6
