"""Stateful decoding engine — the port of ``repro.serving.engine``: greedy
batched LM decoding after a prefill.

A StatefulDecoder is (init_state, step). The reference jits a
``lax.scan`` over the steps and keeps one compiled program per engine and
shape. The port keeps, per engine, one CUDA graph of ONE decode step for
each (state shapes and dtypes, token shape) it meets (`StepGraph`): the
decoder's step keywords are fixed per engine, so they are part of every
key. A state is a tree of tensors (dicts, e.g. the hybrid family's
per-layer dicts; `repro_torch._tree`). Static buffers hold the token and
every leaf of the state (KV caches, recurrent states, ``pos``); the argmax
runs inside the graph, which writes the next token back into the token
buffer and advances ``pos`` in place, so a pass is ``n_steps`` replays with
one copy of each step's token into the output. The graph reads the
weights where they lie, so an in-place update of them is seen at the next
replay; an engine whose ``params`` were rebound to other tensors captures
its step again. On the CPU the steps run eagerly in a Python loop.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from repro_torch._tree import tree_map
from repro_torch.serving.graphs import CAPTURE_LOCK, CapturedGraph, ParamsBinding


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
    return tree_map(torch.Tensor.clone, state)


def _copy_into(buf: torch.Tensor, value: torch.Tensor) -> None:
    if value is not buf:  # a leaf the step wrote in place is its own buffer
        buf.copy_(value)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        with CAPTURE_LOCK:  # a device-wide sync must not meet another thread's capture
            torch.cuda.synchronize(device)


class StepGraph:
    """One CUDA graph of one greedy decode step over static buffers: the
    state's leaves (KV caches written in place, ``pos`` advanced in place,
    leaves the step passes through, such as whisper's ``ck``/``cv``, left
    alone) and the token, which the step reads and overwrites with its
    argmax.

    Not reentrant: hold ``lock`` from `load` to the last read of the
    static buffers.
    """

    def __init__(self, decoder: StatefulDecoder, params, state, token: torch.Tensor):
        self.lock = threading.Lock()
        self.binding = ParamsBinding(params)  # the weights the capture reads
        self.state = copy_state(state)
        self.token = token.clone()

        def body():
            logits, new = decoder.step(params, self.state, self.token)
            tree_map(_copy_into, self.state, new)  # pos + 1 is a new tensor
            # ties go to the first maximum, as jnp.argmax
            self.token.copy_(torch.argmax(logits, dim=-1).to(self.token.dtype))

        self.graph = CapturedGraph(body, token.device)

    def load(self, state, token: torch.Tensor) -> None:
        """Copy a decode state and the current token into the buffers."""
        tree_map(torch.Tensor.copy_, self.state, state)
        self.token.copy_(token)

    def decode(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` replays from the loaded state: (n_steps, B) tokens."""
        tokens = torch.empty((n_steps,) + tuple(self.token.shape), dtype=self.token.dtype,
                             device=self.token.device)
        for i in range(n_steps):
            self.graph.replay()
            tokens[i].copy_(self.token)
        return tokens


def _state_key(state):
    """Names, shapes and dtypes of a state tree, sorted by name."""
    if isinstance(state, dict):
        return tuple((name, _state_key(v)) for name, v in sorted(state.items()))
    return tuple(state.shape), state.dtype


def _program_key(state, token):
    return _state_key(state), tuple(token.shape), token.dtype, token.device


class DecodeEngine:
    """Greedy batched decoding."""

    def __init__(self, decoder: StatefulDecoder, params, *, mesh=None, donate: bool = False):
        # ``mesh`` and ``donate`` are accepted for the reference's signature
        # and ignored: the port runs on one device (the mesh slice is
        # ROADMAP.md Queue 1 item 12), and it never consumes the caller's
        # state, since every pass decodes from a copy
        self.decoder = decoder
        self.params = params
        self.mesh = mesh
        self._lock = threading.Lock()
        self._graphs = {}  # guarded-by: _lock

    def step_graph(self, state, token: torch.Tensor) -> StepGraph:
        """This engine's decode-step graph for ``state``'s and ``token``'s
        shapes and dtypes (captured at the first request, and again once
        ``params`` holds other tensors)."""
        key = _program_key(state, token)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None or not graph.binding.same_tensors(self.params):
                graph = self._graphs[key] = StepGraph(self.decoder, self.params, state, token)
            return graph

    def _multi_step(self, state, token, n_steps: int):
        """Eager decoding (the CPU path): ``state`` is decoded in place."""
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
        a warm-up pass, then a timed pass from the same initial state. On
        the card the warm-up pass captures the step (at the first call for
        these shapes) and replays it; the timed pass only replays."""
        device = first_token.device
        B = first_token.shape[0]
        if device.type != "cuda":
            self._multi_step(copy_state(state), first_token, n_steps)  # warm-up
            start = copy_state(state)  # copied outside the timed pass
            t0 = time.perf_counter()
            tokens, state = self._multi_step(start, first_token, n_steps)
            dt = time.perf_counter() - t0
            return tokens, state, (n_steps * B) / dt
        graph = self.step_graph(state, first_token)
        with graph.lock:
            graph.load(state, first_token)
            graph.decode(n_steps)  # warm-up
            graph.load(state, first_token)  # copied outside the timed pass
            _sync(device)
            t0 = time.perf_counter()
            tokens = graph.decode(n_steps)
            _sync(device)
            dt = time.perf_counter() - t0
            final = copy_state(graph.state)
        return tokens, final, (n_steps * B) / dt
