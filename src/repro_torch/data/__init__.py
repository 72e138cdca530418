"""The token data pipeline: a copy of ``repro.data`` (numpy and the stdlib)."""
