"""Adam(W) with global-norm clipping and schedules — the port of
``repro.training.optimizer``.

Plain functions on nested dicts of tensors, following the reference's
arithmetic line by line (``torch.optim.Adam`` clips, schedules and decays
otherwise). The optimizer state mirrors the param tree; its ``step`` is a
0-d int32 tensor on the params' device, so an update never waits for the
host. ``adam_state_specs`` gives the state's ``ShardSpec`` tree, the
params' own (``runtime.sharding`` maps it onto a mesh).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup_steps: int = 0
    decay_steps: int = 0  # 0 → constant after warmup
    min_lr_ratio: float = 0.1


def adam_init(params, keep_master: bool = False):
    """``keep_master=True`` for bf16-stored params: fp32 master copies live
    in the optimizer state."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(tree_leaves(params)).device
    state = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if keep_master:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def adam_state_specs(param_specs, keep_master: bool = False):
    """Optimizer-state ShardSpec tree mirroring the params."""
    from repro_torch.nn.init import ShardSpec

    state = {
        "m": param_specs,
        "v": param_specs,
        "step": ShardSpec(()),
    }
    if keep_master:
        state["master"] = param_specs
    return state


def schedule_lr(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    step_f = step.to(torch.float32)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.warmup_steps > 0:
        warm = torch.clamp(step_f / cfg.warmup_steps, max=1.0)
        lr = lr * warm
    if cfg.decay_steps > 0:
        frac = torch.clamp((step_f - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        lr = lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cosine)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adam_update(grads, opt_state, params, cfg: AdamConfig):
    """Returns (new_params, new_opt_state, metrics). Nothing is updated in
    place: the new params and state are new tensors."""
    step = opt_state["step"] + 1
    if cfg.clip_norm > 0:
        grads, grad_norm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        grad_norm = global_norm(grads)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v, master=None):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        base = master if master is not None else p.to(torch.float32)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * base
        new_master = base - lr * delta
        return new_master.to(p.dtype), m_new, v_new, new_master

    has_master = "master" in opt_state
    if has_master:
        out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"], opt_state["master"])
    else:
        out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    # the leaves of ``out`` are (param, m, v, master) tuples: split them
    def part(i):
        return tree_map(lambda _, o: o[i], params, out)

    new_state = {"m": part(1), "v": part(2), "step": step}
    if has_master:
        new_state["master"] = part(3)
    metrics = {"grad_norm": grad_norm, "lr": lr}
    return part(0), new_state, metrics
