"""The port's engine: chunked, lane-bucketed packed simulation."""
