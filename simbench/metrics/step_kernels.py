"""Kernels the device ran per simulated step in the traced window."""


def read(rec):
    k = rec.get("kernels")
    return len(k) / rec["steps"] if k and rec["steps"] else None
