"""Instructions simulated by every call of the window over the window's
length on the host's clock: from the clients' start to the last answer."""


def read(rec):
    return rec["instructions"] / rec["window_host_s"] if rec["window_host_s"] > 0 else None
