"""The engine's packing of a call (``pack_workloads`` and
``pad_packed_lanes`` as ``simulate_many`` calls them, timed by the harness
around them), mean over the traced window's calls."""


def read(rec):
    s = rec.get("pack_s")
    return 1e3 * sum(s) / len(s) if s else None
