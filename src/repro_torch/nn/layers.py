"""Basic layers: dense, norms, embeddings, MLPs — the port of
``repro.nn.layers``.

Weights keep the reference's layout: a dense kernel is (in, out) and is
used as ``x @ w``. Each use casts its operands to the compute dtype as the
reference does; the port stores matrices already in that dtype (see
``repro_torch.models.lm``), so the cast is then a no-op. The causal
temporal conv of the recurrent families comes with the hybrid slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.init import dense_init, scalar_init, split_keys


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


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(dim, *, device=None):
    return {"g": scalar_init(1.0, (dim,), device=device)}


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

def embed(params, tokens, *, dtype=torch.bfloat16):
    """Token embedding lookup. params: {"w": (V, D)}."""
    return params["w"].to(dtype)[tokens]


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


def mlp(params, x, *, act="gelu", dtype=torch.bfloat16):
    h = _act(act)(dense(params["wi"], x, dtype=dtype))
    return dense(params["wo"], h, dtype=dtype)
