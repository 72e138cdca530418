"""Stateful decoding engine — the port of ``repro.serving.engine``: greedy
batched LM decoding after a prefill.

A StatefulDecoder is (init_state, step). The reference jits a
``lax.scan`` over the steps; the port runs the steps eagerly in a Python
loop on the state's device. Nothing is read back to the host between
steps (the next token is the device-side argmax), so the host only
enqueues work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch


@dataclasses.dataclass
class StatefulDecoder:
    """step(params, state, inputs) -> (outputs, state)."""

    init_state: Callable[..., Any]
    step: Callable[..., Any]
    name: str = "decoder"


def lm_decoder(model, **step_kw) -> StatefulDecoder:
    """``step_kw`` (e.g. ``use_kernel=True``) is forwarded to every
    ``model.decode_step`` call, as the reference's ``Model.decode_step``
    takes it."""

    def step(params, state, token):
        return model.decode_step(params, state, token, **step_kw)

    return StatefulDecoder(
        init_state=model.init_decode_state, step=step, name=f"lm:{model.cfg.name}"
    )


def copy_state(state):
    # decode steps write the KV cache in place: every pass starts from a
    # copy, so the caller's state is left as it was (as with JAX's
    # immutable arrays) and the timed pass starts where the warm-up did
    return {k: v.clone() for k, v in state.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Greedy batched decoding."""

    def __init__(self, decoder: StatefulDecoder, params, *, mesh=None, donate: bool = False):
        # ``mesh`` and ``donate`` are accepted for the reference's signature
        # and ignored: the port runs on one device (the mesh slice is
        # ROADMAP.md Queue 1 item 12), and it never consumes the caller's
        # state, since every pass decodes from a copy (`copy_state`)
        self.decoder = decoder
        self.params = params
        self.mesh = mesh

    def _multi_step(self, state, token, n_steps: int):
        tokens = []
        for _ in range(n_steps):
            logits, state = self.decoder.step(self.params, state, token)
            # ties go to the first maximum, as jnp.argmax
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens.append(token)
        return torch.stack(tokens), state

    @torch.no_grad()
    def generate(self, state, first_token, n_steps: int):
        """Returns (tokens (n_steps, B) int32, final state, tokens/sec):
        a warm-up pass, then a timed pass from the same initial state."""
        device = first_token.device
        self._multi_step(copy_state(state), first_token, n_steps)  # warm-up
        start = copy_state(state)  # copied outside the timed pass
        _sync(device)
        t0 = time.perf_counter()
        tokens, state = self._multi_step(start, first_token, n_steps)
        _sync(device)
        dt = time.perf_counter() - t0
        B = first_token.shape[0]
        return tokens, state, (n_steps * B) / dt
