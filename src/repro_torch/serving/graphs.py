"""CUDA graphs of the port's resident programs.

A `CapturedGraph` holds one CUDA graph of ``body``: a function that reads
and writes only tensors that outlive it (its program's static buffers), so
a replay re-runs the same kernels on the same addresses with no Python in
between. Tensors ``body`` allocates come from the graph's private memory
pool and keep their addresses from replay to replay.

The kernel wrappers count launches in Python (`kernels.ops.launches`), and
a replay runs no Python: each graph records how many launches of each
kernel its capture recorded and adds them at every replay, so the counts
keep meaning the launches the card ran. The build's own calls (the warm-up
and the capture) are set-up and leave the counts as they were.

A graph reads its weights at fixed addresses, so an engine whose
``params`` may be rebound to other tensors checks a `ParamsBinding`: the
SimNet chunk graph refills its parameter slots, the decode-step graph is
captured again.

Nothing falls back: a capture, an instantiation or a replay that fails
raises.
"""
from __future__ import annotations

import time
import weakref

import torch

from repro_torch._tree import tree_leaves
from repro_torch.kernels import ops


class CapturedGraph:
    """One CUDA graph of ``body`` on ``device``.

    ``body`` runs once eagerly on a side stream first: a kernel's first
    call loads its library and sets its shared-memory limit, neither of
    which may happen inside a capture. The capture uses the
    ``thread_local`` error mode, so another thread's CUDA work during the
    capture does not invalidate it. ``capture_seconds`` and
    ``instantiate_seconds`` time the two halves of the build on the host.
    """

    def __init__(self, body, device: torch.device):
        before = dict(ops.launches)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.no_grad():
            with torch.cuda.stream(side):
                body()
            current.wait_stream(side)
            # keep_graph: instantiate separately, so that its time is seen
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                start = dict(ops.launches)
                body()
                captured = {k: ops.launches[k] - start[k] for k in start}
            t1 = time.perf_counter()
            self.graph.instantiate()
            t2 = time.perf_counter()
        self.capture_seconds = t1 - t0
        self.instantiate_seconds = t2 - t1
        self.launches = {k: n for k, n in captured.items() if n}
        for k in before:
            ops.launches[k] = before[k]

    def replay(self) -> None:
        """Run the graph on the current stream (asynchronously)."""
        self.graph.replay()
        for k, n in self.launches.items():
            ops.launches[k] += n


class ParamsBinding:
    """Which weights a graph was given: weak references to the tensors of
    a params tree and each one's version counter.

    `same_tensors` holds when another tree has the very same tensors, in
    the same order; a tree rebound to new tensors fails it even when the
    versions agree (a new tensor starts at version 0, as the old one did).
    `unchanged` also needs every version as it was: an in-place update
    bumps it. A weak reference dies with its tensor, so a freed tensor's
    address or ``id`` reused by a new one never passes for it.
    """

    def __init__(self, params):
        leaves = list(tree_leaves(params))
        self._refs = [weakref.ref(t) for t in leaves]
        self._versions = [t._version for t in leaves]

    def same_tensors(self, params) -> bool:
        leaves = list(tree_leaves(params))
        return len(leaves) == len(self._refs) and all(
            r() is t for r, t in zip(self._refs, leaves))

    def unchanged(self, params) -> bool:
        return self.same_tensors(params) and [t._version for t in tree_leaves(params)] == self._versions
