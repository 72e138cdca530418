"""Device kernel time per simulated step (one step of every lane of a
call) over the steps replayed in the traced window."""


def read(rec):
    k = rec.get("kernels")
    return 1e6 * sum(s for _, s in k) / rec["steps"] if k and rec["steps"] else None
