"""Copies of the reference's numpy discrete-event simulator (``repro.des``),
so the port can make its own traces where JAX is not installed."""
