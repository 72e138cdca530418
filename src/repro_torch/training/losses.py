"""Losses: next-token cross-entropy and the SimNet hybrid
classification+regression loss (paper §2.3) — the port of
``repro.training.losses``.

Every loss is computed in f32. The reference picks the label's logit by a
one-hot contraction over the vocabulary; the port gathers it. Every other
term of that contraction is an exact zero, so the two give the same value
without a (B, S, V) one-hot (1 GB a microbatch at tinyllama-1.1b's full
width and seq 2048).
"""
from __future__ import annotations

import torch


def _lse(lg):
    """Stable log-sum-exp over the last axis, as the reference writes it."""
    m = torch.amax(lg, dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]


def _pick(lg, labels):
    return torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]


def next_token_ce(logits, tokens, loss_mask=None):
    """Shifted LM loss. logits: (B,S,V); tokens: (B,S) int."""
    lg = logits[:, :-1, :].to(torch.float32)
    nll = _lse(lg) - _pick(lg, tokens[:, 1:])  # (B, S-1)
    if loss_mask is not None:
        w = loss_mask[:, 1:].to(torch.float32)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(nll)


def hybrid_latency_loss(cls_logits, reg_out, targets, n_classes):
    """SimNet hybrid head loss: CE over {0..n_classes-2, overflow} +
    squared error on the regression output (the paper trains both heads).

    cls_logits: (..., n_classes); reg_out: (...,); targets: (...,) float.
    """
    t_int = torch.clamp(targets, min=0).to(torch.int32)
    cls_target = torch.where(t_int >= n_classes - 1, n_classes - 1, t_int)
    lg = cls_logits.to(torch.float32)
    ce = _lse(lg) - _pick(lg, cls_target)
    # regression on raw latency (f32), trained everywhere but most useful
    # for the overflow class
    se = torch.square(reg_out.to(torch.float32) - targets.to(torch.float32))
    return torch.mean(ce) + torch.mean(se)


def mse(pred, target):
    return torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)))
