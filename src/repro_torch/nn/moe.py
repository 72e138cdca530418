"""Mixture-of-Experts layer: top-k routing, GShard-style dense dispatch —
the port of ``repro.nn.moe``.

Dispatch and combine are one-hot tensors over (groups, group_size,
experts, capacity) and einsums, as in the reference: a plain PyTorch
product (cuBLAS on the card), with no kernel of its own. The router runs
in f32, the experts in the compute dtype; tokens past an expert's
capacity are dropped from the expert path (the residual passes them
through).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.nn.init import ShardSpec, dense_init, split_keys


def moe_params(generator, d_model, d_ff, n_experts):
    kr, kg, ku, ko = split_keys(generator, 4)

    def expert_w(g, a, b):
        # one (a, b * E) fan-in-scaled draw, split into E (a, b) blocks
        w = dense_init(g, a, b * n_experts)
        return w.reshape(a, n_experts, b).permute(1, 0, 2).contiguous()  # (E, a, b)

    return {
        "router": dense_init(kr, d_model, n_experts),  # (D, E), used in f32
        "wi_gate": expert_w(kg, d_model, d_ff),  # (E, D, F)
        "wi_up": expert_w(ku, d_model, d_ff),  # (E, D, F)
        "wo": expert_w(ko, d_ff, d_model),  # (E, F, D)
    }


def moe_specs():
    """The expert stacks lead with ``expert``: ``expert → model`` with
    ``cfg.moe_ep``, else ``mlp → model`` (`runtime.sharding.rules_for`)."""
    return {
        "router": ShardSpec(("embed", None)),
        "wi_gate": ShardSpec(("expert", "embed", "mlp")),
        "wi_up": ShardSpec(("expert", "embed", "mlp")),
        "wo": ShardSpec(("expert", "mlp", "embed")),
    }


def _capacity(group_size: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(group_size * top_k / n_experts * factor))
    return max(4, ((c + 3) // 4) * 4)


def _top_k(x, k: int):
    """The ``k`` largest entries of the last axis and their indices, ties
    going to the lower index as ``jax.lax.top_k`` (``torch.topk`` does not
    promise an order among equal values; a stable sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int, dtype):
    # jax.nn.one_hot: an index outside [0, n) gives a row of zeros
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _expert_positions(gate_idx, n_experts: int):
    """Each (token, choice)'s position in its expert's buffer, counted
    token-major, choice-minor: gate_idx (G, g, k) -> (G, g, k) int32."""
    G, g, k = gate_idx.shape
    onehot = _one_hot(gate_idx.reshape(G, g * k), n_experts, torch.int32)  # (G, g*k, E)
    pos_in_expert = torch.cumsum(onehot, dim=1) - onehot  # position of each choice
    return torch.sum(pos_in_expert * onehot, dim=-1).reshape(G, g, k)


def moe_apply(params, x, *, n_experts: int, top_k: int, capacity_factor: float = 1.25,
              group_size: int = 1024, act=F.silu, dtype=torch.bfloat16, constrain=None):
    """x: (B, T, D) -> ((B, T, D), router logits (G, g, E) f32). Router in
    f32, experts in the compute dtype. ``constrain`` (the reference's
    sharding hook) places the token groups on ``batch`` and the expert
    buffers on ``("batch", "expert")``."""
    B, T, D = x.shape
    n_tokens = B * T
    g = min(group_size, n_tokens)
    G = n_tokens // g
    if G * g != n_tokens:
        raise ValueError(f"group_size {g} must divide tokens {n_tokens}")
    xt = x.reshape(G, g, D)
    if constrain is not None:
        xt = constrain(xt, ("batch", None, None))

    # --- routing (fp32) ---
    router_logits = torch.einsum("Ggd,de->Gge", xt.to(torch.float32),
                                 params["router"].to(torch.float32))
    gate_vals, gate_idx = _top_k(router_logits, top_k)  # (G, g, k)
    gate_probs = torch.softmax(gate_vals, dim=-1)  # normalised over the chosen

    C = _capacity(g, n_experts, top_k, capacity_factor)
    pos = _expert_positions(gate_idx, n_experts)
    keep = pos < C  # overflow drops

    # --- dispatch / combine tensors: (G, g, E, C) ---
    e_oh = _one_hot(gate_idx, n_experts, dtype)  # (G, g, k, E)
    c_oh = _one_hot(pos, C, dtype)  # (G, g, k, C)
    keep_f = keep.to(dtype)[..., None, None]
    disp_k = e_oh[..., :, None] * c_oh[..., None, :] * keep_f  # (G, g, k, E, C)
    dispatch = torch.sum(disp_k, dim=2)  # (G, g, E, C)
    combine = torch.sum(disp_k * gate_probs.to(dtype)[..., None, None], dim=2)

    # --- expert compute ---
    expert_in = torch.einsum("GgEC,Ggd->GECd", dispatch, xt.to(dtype))
    if constrain is not None:
        expert_in = constrain(expert_in, ("batch", "expert", None, None))
    hg = torch.einsum("GECd,Edf->GECf", expert_in, params["wi_gate"].to(dtype))
    hu = torch.einsum("GECd,Edf->GECf", expert_in, params["wi_up"].to(dtype))
    h = act(hg) * hu
    expert_out = torch.einsum("GECf,Efd->GECd", h, params["wo"].to(dtype))
    if constrain is not None:
        expert_out = constrain(expert_out, ("batch", "expert", None, None))
    if isinstance(expert_out, DTensor):
        # gathered over the experts: the combine einsum flattens (E, C),
        # which torch 2.11's DTensor refuses with E split
        expert_out = expert_out.redistribute(
            expert_out.device_mesh,
            [Replicate() if p.is_shard(1) else p for p in expert_out.placements])

    out = torch.einsum("GgEC,GECd->Ggd", combine, expert_out)
    return out.reshape(B, T, D), router_logits


def load_balancing_loss(router_logits, *, n_experts: int):
    """Switch-style auxiliary loss: n_e * sum_e f_e * p_e.

    router_logits: (G, g, E) fp32.
    """
    probs = torch.softmax(router_logits, dim=-1)
    top1 = torch.argmax(router_logits, dim=-1)
    f = torch.mean(_one_hot(top1, n_experts, torch.float32), dim=(0, 1))
    p = torch.mean(probs, dim=(0, 1))
    return n_experts * torch.sum(f * p)


def dropped_share(router_logits, *, n_experts: int, top_k: int, capacity_factor: float):
    """The share of routed (token, choice) pairs that `moe_apply` drops at
    capacity for these router logits (G, g, E): a count the decode path
    never computes, for reports."""
    pos = _expert_positions(_top_k(router_logits, top_k)[1], n_experts)
    C = _capacity(router_logits.shape[1], n_experts, top_k, capacity_factor)
    return (pos >= C).to(torch.float32).mean()
