"""Fleet-scale runtime: a copy of ``repro.runtime.straggler`` (stdlib only),
the ports of ``repro.runtime.sharding`` (logical-axis rules onto DTensor
placements), ``repro.runtime.elastic`` (mesh plans) and
``repro.runtime.roofline`` (on the H100's figures), and ``opcount``, the
counterpart of ``repro.runtime.hlo`` (FLOPs, bytes and collectives
counted from the ops a step dispatches)."""
