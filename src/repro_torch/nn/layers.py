"""Basic layers: dense, norms, embeddings, MLPs, the causal temporal conv
— the port of ``repro.nn.layers``.

Weights keep the reference's layout: a dense kernel is (in, out) and is
used as ``x @ w``. Each use casts its operands to the compute dtype as the
reference does; the port stores matrices already in that dtype (see
``repro_torch.models.lm``), so the cast is then a no-op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.nn.init import ShardSpec, dense_init, scalar_init, split_keys


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense(params, x, *, dtype=torch.bfloat16):
    """x @ w (+ b). params: {"w": (in, out), optional "b": (out,)}."""
    y = x.to(dtype) @ params["w"].to(dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y


def dense_params(generator, in_dim, out_dim, *, bias=False, scale=1.0):
    p = {"w": dense_init(generator, in_dim, out_dim, scale=scale)}
    if bias:
        p["b"] = scalar_init(0.0, (out_dim,), device=generator.device)
    return p


def dense_specs(axes, *, bias=False):
    s = {"w": ShardSpec(tuple(axes))}
    if bias:
        s["b"] = ShardSpec((axes[-1],))
    return s


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(dim, *, device=None):
    return {"g": scalar_init(1.0, (dim,), device=device)}


def rmsnorm_specs(axis="embed"):
    return {"g": ShardSpec((axis,))}


def rmsnorm(params, x, *, eps=1e-6, dtype=torch.bfloat16, zero_centered=False):
    """RMSNorm in fp32 math, output in compute dtype.

    ``zero_centered`` follows gemma convention (scale = 1 + g).
    """
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = params["g"].to(torch.float32)
    if zero_centered:
        y = y * (1.0 + g)
    else:
        y = y * g
    return y.to(dtype)


def layernorm_params(dim, *, device=None):
    return {"g": scalar_init(1.0, (dim,), device=device),
            "b": scalar_init(0.0, (dim,), device=device)}


def layernorm_specs():
    return {"g": ShardSpec(("embed",)), "b": ShardSpec(("embed",))}


def layernorm(params, x, *, eps=1e-5, dtype=torch.bfloat16):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["g"].to(torch.float32) + params["b"].to(torch.float32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed_specs():
    return {"w": ShardSpec(("vocab", "embed"))}


def embed(params, tokens, *, dtype=torch.bfloat16):
    """Token embedding lookup. params: {"w": (V, D)}. A table placed on a
    mesh (a DTensor, its rows split over ``"model"`` by ``vocab``) is
    looked up by `repro_torch.runtime.sharding.vocab_parallel_rows`."""
    w = params["w"]
    if isinstance(w, DTensor):
        from repro_torch.runtime.sharding import vocab_parallel_rows

        return vocab_parallel_rows(w.to(dtype), tokens)
    return w.to(dtype)[tokens]


def unembed(params, x, *, dtype=torch.bfloat16):
    """Project hidden states to logits with the (tied or separate) table."""
    return x.to(dtype) @ params["w"].to(dtype).T


# ---------------------------------------------------------------------------
# activations / MLPs
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _act(name):
    # jax.nn.gelu is the tanh approximation by default, so "gelu" maps to
    # it too (F.gelu's own default is the exact erf form)
    return {
        "silu": F.silu,
        "gelu": _gelu_tanh,
        "gelu_tanh": _gelu_tanh,
        "relu": F.relu,
    }[name]


def gated_mlp_params(generator, d_model, d_ff):
    k1, k2, k3 = split_keys(generator, 3)
    return {
        "wi_gate": dense_init(k1, d_model, d_ff),
        "wi_up": dense_init(k2, d_model, d_ff),
        "wo": dense_init(k3, d_ff, d_model),
    }


def gated_mlp_specs(axes_up=("embed", "mlp"), axes_down=("mlp", "embed")):
    return {"wi_gate": ShardSpec(axes_up), "wi_up": ShardSpec(axes_up),
            "wo": ShardSpec(axes_down)}


def gated_mlp(params, x, *, act="silu", dtype=torch.bfloat16):
    """SwiGLU-family MLP: wo( act(x@wi_gate) * (x@wi_up) )."""
    x = x.to(dtype)
    xg = x @ params["wi_gate"].to(dtype)
    xu = x @ params["wi_up"].to(dtype)
    h = _act(act)(xg) * xu
    return h @ params["wo"].to(dtype)


def mlp_params(generator, d_in, d_hidden, d_out, *, bias=True):
    k1, k2 = split_keys(generator, 2)
    return {"wi": dense_params(k1, d_in, d_hidden, bias=bias),
            "wo": dense_params(k2, d_hidden, d_out, bias=bias)}


def mlp_specs(axes_up=("embed", "mlp"), axes_down=("mlp", "embed"), *, bias=True):
    return {"wi": dense_specs(axes_up, bias=bias), "wo": dense_specs(axes_down, bias=bias)}


def mlp(params, x, *, act="gelu", dtype=torch.bfloat16):
    h = _act(act)(dense(params["wi"], x, dtype=dtype))
    return dense(params["wo"], h, dtype=dtype)


# ---------------------------------------------------------------------------
# temporal (causal) conv1d — used by RG-LRU recurrent block frontends
# ---------------------------------------------------------------------------

def causal_conv1d_params(generator, width, dim):
    return {"w": dense_init(generator, width, dim),
            "b": scalar_init(0.0, (dim,), device=generator.device)}


def causal_conv1d_specs():
    return {"w": ShardSpec((None, "embed")), "b": ShardSpec(("embed",))}


def causal_conv1d(params, x, *, dtype=torch.bfloat16):
    """Depthwise causal temporal conv. x: (B, T, D); w: (W, D)."""
    w = params["w"].to(dtype)
    width = w.shape[0]
    x = x.to(dtype)
    # zero rows ahead of T, as F.pad would give them; zeros of x's own first
    # row keep x's placements on a mesh (torch 2.11's DTensor pad rule
    # fails on a channel-split x: an IndexError in its redistribute plan)
    xp = torch.cat([torch.zeros_like(x[:, :1])] * (width - 1) + [x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i: i + x.shape[1], :] * w[i]
    return y + params["b"].to(dtype)


def causal_conv1d_step(params, x_t, conv_state, *, dtype=torch.bfloat16):
    """Single-token decode step. conv_state: (B, W-1, D) past inputs.
    Returns (y (B, D), new conv_state)."""
    w = params["w"].to(dtype)
    width = w.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, W, D)
    y = torch.einsum("bwd,wd->bd", window.to(dtype), w) + params["b"].to(dtype)
    new_state = window[:, 1:, :] if width > 1 else conv_state
    return y, new_state
