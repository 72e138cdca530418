"""Losses: next-token cross-entropy and the SimNet hybrid
classification+regression loss (paper §2.3) — the port of
``repro.training.losses``.

Every loss is computed in f32. The reference picks the label's logit by a
one-hot contraction over the vocabulary; the port gathers it. Every other
term of that contraction is an exact zero, so the two give the same value
without a (B, S, V) one-hot (1 GB a microbatch at tinyllama-1.1b's full
width and seq 2048).

Logits placed on a mesh (a DTensor, its vocab split over ``"model"`` by
the tied unembed) go through `_sharded_next_token_ce`: a sharded
log-sum-exp and the label's logit picked on the rank that holds it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate


def _lse(lg):
    """Stable log-sum-exp over the last axis, as the reference writes it."""
    m = torch.amax(lg, dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]


def _pick(lg, labels):
    return torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]


def next_token_ce(logits, tokens, loss_mask=None):
    """Shifted LM loss. logits: (B,S,V); tokens: (B,S) int."""
    if isinstance(logits, DTensor):
        return _sharded_next_token_ce(logits, tokens, loss_mask)
    lg = logits[:, :-1, :].to(torch.float32)
    nll = _lse(lg) - _pick(lg, tokens[:, 1:])  # (B, S-1)
    if loss_mask is not None:
        w = loss_mask[:, 1:].to(torch.float32)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(nll)


def _sharded_next_token_ce(logits, tokens, loss_mask):
    """`next_token_ce` of DTensor logits, computed on each rank's shard.
    The vocab split over mesh dims (``vocab → model``) is summed by hand:
    each rank's log-sum-exp partial around the max over all ranks (an
    all-reduce of the max, which takes no gradient: the log-sum-exp's
    gradient does not depend on it), the partial sums of exp all-reduced;
    the label's logit picked on the rank whose shard holds it, zero on
    the others, and all-reduced (no (B, S, V) gather). Every other mesh
    dim (``batch`` over ``data``) is DTensor's own. Where no mesh dim of
    more than one rank splits the vocab, each rank runs `next_token_ce`'s
    own arithmetic on its rows, bit for bit."""
    from repro_torch.runtime.sharding import place, shard_offsets, split_over

    mesh = logits.device_mesh
    lg = logits[:, :-1, :].to(torch.float32)
    batch_pl = tuple(Replicate() if p.is_shard(2) else p for p in lg.placements)

    def mine(t):  # this rank's rows of a plain (B, S-1) tensor, as lg's
        return place(t, mesh, batch_pl).to_local()

    def reduced(t, op="sum"):  # local partials over the vocab dims -> DTensor
        pl = [Partial(op) if p.is_shard(2) else p for p in lg.placements]
        return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(mesh, batch_pl)

    labels = mine(tokens[:, 1:].to(torch.int64))
    local = lg.to_local()
    if split_over(lg, 2):
        m = reduced(torch.amax(local, dim=-1).detach(), "max")
        sumexp = reduced(torch.sum(torch.exp(local - m.to_local()[..., None]), dim=-1))
        lse = torch.log(sumexp) + m
        lo, n = shard_offsets(lg, 2)
        inside = (labels >= lo) & (labels < lo + n)
        picked = torch.gather(local, -1, (labels - lo).clamp(0, n - 1)[..., None])[..., 0]
        pick = reduced(torch.where(inside, picked, torch.zeros((), device=picked.device)))
        nll = lse - pick
    else:
        nll = DTensor.from_local(_lse(local) - _pick(local, labels), mesh, batch_pl,
                                 run_check=False)
    if loss_mask is not None:
        w = place(loss_mask[:, 1:].to(torch.float32), mesh, batch_pl)
        loss = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


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
