"""Train-step factory: microbatched gradient accumulation, remat (inside
the model), Adam update — the port of ``repro.training.train_loop``.

Gradients come from autograd: each step takes the params as leaves that
require grad (views of the given tensors) and returns the new params from
`repro_torch.training.optimizer.adam_update`, which need none. The
reference's ``constrain``, ``grad_shardings`` and ``layer_specs`` place
values on a device mesh; they come with the LM half of the port's mesh
(ROADMAP.md Queue 1 item 12a-LM), and the port takes none of them yet.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.losses import next_token_ce

MOE_AUX_WEIGHT = 0.01


def make_loss_fn(model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = next_token_ce(logits, batch["tokens"], batch.get("loss_mask"))
        metrics = {"ce_loss": loss}
        if "moe_loss" in aux:
            loss = loss + MOE_AUX_WEIGHT * aux["moe_loss"]
            metrics["moe_loss"] = aux["moe_loss"]
        return loss, metrics

    return loss_fn


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``, by autograd
    on leaves that view ``params``. Loss and metrics come back detached,
    the grads in ``params``' structure."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _split_microbatches(batch, n):
    """Every (B, ...) leaf as (n, B//n, ...); ``mrope_positions`` (3, B, S)
    as (n, 3, B//n, S): its batch axis is the second. It is picked by its
    key: the reference picks any leaf of leading size 3 and rank >= 3, which
    at a batch of 3 also splits whisper's frames and qwen2-vl's patches on
    their second axis (ROADMAP.md Queue 3)."""

    def rs(k, x):
        if x.ndim == 0:
            return x
        if k == "mrope_positions":
            return x.reshape(3, n, x.shape[1] // n, *x.shape[2:]).transpose(0, 1)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    return {k: rs(k, v) for k, v in batch.items()}


def make_train_step(model, adam_cfg: opt_lib.AdamConfig, *, accum_steps: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    With accum_steps > 1 the microbatches run one after another; their
    gradients are summed in f32 and the sum divided by ``accum_steps``, as
    the reference's scan and its unrolled form (``accum_unroll``) do; one
    Python loop gives that arithmetic, so the port has no such option. Metrics:
    ``loss``, ``ce_loss``, ``moe_loss`` (MoE), ``grad_norm`` and ``lr``.
    """
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            micro = _split_microbatches(batch, accum_steps)
            grads, loss, metrics = None, None, None
            for i in range(accum_steps):
                mb = {k: v[i] if v.ndim else v for k, v in micro.items()}
                l, m, g = loss_and_grads(loss_fn, params, mb)
                if grads is None:  # the sum is kept in place: one f32 tree
                    grads, loss, metrics = tree_map(lambda t: t.to(torch.float32), g), l, m
                else:
                    tree_map(lambda a, b: a.add_(b), grads, g)
                    loss = loss + l
                    metrics = {k: metrics[k] + v for k, v in m.items()}
                del g
            tree_map(lambda g: g.div_(accum_steps), grads)
            loss = loss / accum_steps
            metrics = {k: v / accum_steps for k, v in metrics.items()}

        new_params, new_opt, opt_metrics = opt_lib.adam_update(grads, opt_state, params, adam_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step
