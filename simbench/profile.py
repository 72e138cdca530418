"""The reduction of a ``torch.profiler`` trace of the traced window to what
the per-layer readers and the ``breakdown`` read: device operations
(kernels, copies, memsets) as intervals on the profiler's clock, the time
the device was busy (the union of those intervals), and the idle gaps
named by what the host was doing then."""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

COPY = re.compile(r"^(Memcpy|Memset|memcpy|memset)")
WINDOW_SPAN = "simbench.window"
SPAN_PREFIX = "simbench."


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s)[:64]


def reduce(events, spans=()) -> dict:
    """From ``prof.events()``: the window (from the first device operation
    after the ``simbench.window`` span opens to the span's end: the
    clients' first packing, before anything reaches the card, is a
    start-up the steady state does not have), the device operations inside
    it, their union, the profiler's host events, and the harness's
    ``spans`` ((label, start, end) in seconds after the span opened) on the
    profiler's clock."""
    from torch.autograd import DeviceType

    window = None
    device: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep"):
                continue
            device.append((e.name, start, end))
        elif e.name == WINDOW_SPAN:
            window = (start, end)
        elif not e.name.startswith("ProfilerStep"):
            host.append((e.name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = window
    labelled = [(f"{SPAN_PREFIX}{n}", w0 + a * 1e6, w0 + b * 1e6) for n, a, b in spans]
    w0 = min((s for _, s, t in device if s >= w0 and t <= w1), default=w0)
    inside = [(n, max(s, w0), min(t, w1)) for n, s, t in device if t > w0 and s < w1]
    merged = []
    for _, s, t in sorted(inside, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    return {"window_us": (w0, w1), "ops": inside, "busy_us": busy, "merged": merged,
            "host": host + labelled}


def kernels(trace: dict) -> List[Tuple[str, float]]:
    """(name, seconds) of each kernel in the window (copies and memsets
    left out)."""
    return [(n, (t - s) * 1e-6) for n, s, t in trace["ops"] if not COPY.match(n)]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named ``<innermost host op>__<innermost harness span>`` at the
    gap's middle."""
    by = defaultdict(float)
    for n, s, t in trace["ops"]:
        by[_name(n)] += (t - s) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = trace["window_us"]
    edges = [w0] + [x for iv in trace["merged"] for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)[:top]
    names = [h[0] for h in trace["host"]]
    starts = np.array([h[1] for h in trace["host"]] or [0.0])
    ends = np.array([h[2] for h in trace["host"]] or [0.0])
    span = ends - starts
    out = []
    for length, lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        hit = np.flatnonzero((starts <= mid) & (ends >= mid)) if names else []
        op = [i for i in hit if not names[i].startswith(SPAN_PREFIX)]
        sp = [i for i in hit if names[i].startswith(SPAN_PREFIX)]
        what = names[min(op, key=lambda i: span[i])] if op else "host"
        inner = {}  # each client's innermost span
        for i in sorted(sp, key=lambda i: -span[i]):
            label = names[i][len(SPAN_PREFIX):]
            inner[label.split(".")[0]] = label
        where = "+".join(inner[k] for k in sorted(inner)) or "none"
        out.append([_name(f"{what}__{where}"), length * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


def summary(trace: dict) -> Dict[str, float]:
    w0, w1 = trace["window_us"]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": trace["busy_us"] * 1e-6}
