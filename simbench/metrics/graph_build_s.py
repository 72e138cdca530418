"""Seconds the program cache spent building programs during set-up
(``CompileCache.delta_since``: the chunk graph's capture and instantiation)."""


def read(rec):
    d = rec.get("cache_setup")
    return d["compile_seconds"] if d and d.get("misses") else None
