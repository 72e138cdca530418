"""The share of the traced window in which no kernel, copy or memset ran
on the card (one minus the union of the device's operations)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
