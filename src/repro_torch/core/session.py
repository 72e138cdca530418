"""Training a SimNet latency predictor — the port of the training half of
``repro.core.session``: the hybrid loss, the Adam training loop and the
paper's per-latency prediction error.

Training runs the unfused predictor (`core.predictor.apply_raw`, plain
PyTorch) under autograd, as the reference trains its unfused predictor:
the hand-written kernels have no backward. The reference's `SimNet`
session routes every simulation through the `SimServe` serving tier, so
it is ported together with that tier (ROADMAP.md Queue 1, items 8-9).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.predictor import (
    REG_SCALE,
    PredictorConfig,
    apply_raw,
    decode_latency,
    init_predictor,
    split_heads,
)
from repro_torch.training.optimizer import AdamConfig, adam_init, adam_update


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
