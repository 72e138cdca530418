"""SimNet latency predictors in PyTorch (paper §2.3) — the port of
``repro.core.predictor``.

Models over input (B, N, 50) with N = 1 + ctx_len (current + context).
This slice ports the 1-D CNNs ``c1``/``c3``: kernel=2 stride=2
non-overlapping hierarchical convolutions (a k2s2 conv is a reshape + one
GEMM), then two FC layers. The other kinds of the reference (fc2/fc3, rb7,
lstm2, ithemal_lstm2, tx6) raise ``NotImplementedError`` until they are
ported (ROADMAP.md, Queue 1).

Output heads: hybrid = per-latency 10-way classification (cycles 0..8 +
overflow) + regression fallback; reg = regression only.

Parameters are nested dicts of tensors with the reference's layout
(``{"conv0": {"w": (2C, Co), "b": (Co,)}, ..., "fc0": ..., "fc1": ...}``),
so weights cross between the packages through `params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.features import N_FEATURES
from repro_torch.core.simulator import torch_dtype

N_HEADS = 3  # fetch, execution, store
REG_SCALE = 1.0 / 64.0  # regression head works in scaled-cycle space
PORTED_KINDS = ("c1", "c3")


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


def _require_ported(cfg: PredictorConfig):
    if cfg.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"predictor kind {cfg.kind!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(PORTED_KINDS)}); see ROADMAP.md Queue 1, "
            "'other predictor kinds'"
        )


def param_shapes(cfg: PredictorConfig) -> dict:
    """{layer: {"w": shape, "b": shape}} of a c1/c3 model."""
    _require_ported(cfg)
    depth = int(cfg.kind[1])
    chans = [N_FEATURES] + list(cfg.channels[:depth])
    shapes = {f"conv{i}": {"w": (2 * chans[i], chans[i + 1]), "b": (chans[i + 1],)}
              for i in range(depth)}
    n_pos = cfg.seq_padded >> depth
    shapes["fc0"] = {"w": (n_pos * chans[-1], cfg.hidden), "b": (cfg.hidden,)}
    shapes["fc1"] = {"w": (cfg.hidden, cfg.out_dim), "b": (cfg.out_dim,)}
    return shapes


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_predictor(generator: torch.Generator, cfg: PredictorConfig,
                   device: DeviceLike = None) -> dict:
    """Fan-in scaled truncated-normal weights (2-sigma, as the reference's
    ``dense_init``) and zero biases, drawn from ``generator`` in layer
    order. The generator must be a CPU generator, so the same seed gives
    the same weights on every device."""
    dev = resolve_device(device)
    params = {}
    for name, s in param_shapes(cfg).items():
        fan_in = s["w"][0]
        std = 1.0 / math.sqrt(fan_in)
        w = torch.empty(s["w"], dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        params[name] = {"w": w.to(dev), "b": torch.zeros(s["b"], dtype=torch.float32, device=dev)}
    return params


def params_from_numpy(tree, pcfg: PredictorConfig, device: DeviceLike = None) -> dict:
    """The reference's params (a nested dict of arrays, as its
    ``init_predictor`` or ``PredictorArtifact`` give them) as the port's
    params on ``device``. Shapes are checked against ``pcfg``."""
    dev = resolve_device(device)
    out = {}
    for name, s in param_shapes(pcfg).items():
        if name not in tree:
            raise ValueError(f"params lack layer {name!r} for kind {pcfg.kind!r}")
        out[name] = {}
        for k in ("w", "b"):
            a = np.asarray(tree[name][k], dtype=np.float32)
            if a.shape != s[k]:
                raise ValueError(f"{name}.{k} has shape {a.shape}, expected {s[k]}")
            out[name][k] = torch.from_numpy(a.copy()).to(dev)
    return out


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


def apply_trunk(params, x, cfg: PredictorConfig, use_kernel: bool = False):
    """(B, N, 50) -> (B, hidden) features before the output head.

    With ``use_kernel`` the conv stack runs in `kernels.ops.cnn_trunk`,
    which computes in f32 whatever ``compute_dtype`` is (as the
    reference's kernel wrapper does); the unfused path honours it."""
    _require_ported(cfg)
    kind = cfg.kind
    depth = int(kind[1])
    cdt = torch_dtype(cfg.compute_dtype)
    h = _pad_seq(x.to(cdt), cfg)
    if use_kernel:
        from repro_torch.kernels import ops as kops

        h = kops.cnn_trunk([params[f"conv{i}"] for i in range(depth)], h)
    else:
        for i in range(depth):
            p = {"w": params[f"conv{i}"]["w"].to(cdt), "b": params[f"conv{i}"]["b"].to(cdt)}
            h = conv2s(p, h)
    h = h.reshape(h.shape[0], -1).to(torch.float32)
    h = _dense(params["fc0"], h, act="relu")
    return h, params["fc1"]


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


def make_fused_predict_fn(params, cfg: PredictorConfig):
    """Fused ring-state predictor: model-input assembly + the C3 conv
    trunk run in ONE kernel (`kernels.ops.fused_step`) straight off the
    ring-buffer SimState — the (L, 1+Q, 50) input never reaches device
    memory. The FC head + hybrid decode stay in plain torch.

    Signature matches `make_sim_scan`'s ``predict_state_fn``:
    (state, cur_feat, cur_addr) -> (L, 3) latencies. Requires the ring
    layout, kind == "c3", and an f32 state (the kernel assembles in f32;
    the engine sends a bf16 state to the unfused kernel path).
    """
    if cfg.kind != "c3":
        raise ValueError(
            f"fused_step fuses the C3 trunk; got kind={cfg.kind!r} "
            "(use the unfused use_kernel path for other models)"
        )
    from repro_torch.kernels import ops as kops

    conv = [params[f"conv{i}"] for i in range(3)]

    def predict(state, cur_feat, cur_addr):
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
