"""Fleet-scale runtime: a copy of ``repro.runtime.straggler`` (stdlib only),
and the ports of ``repro.runtime.sharding`` (logical-axis rules onto DTensor
placements) and ``repro.runtime.elastic`` (mesh plans). The HLO and
roofline modules come with the dry run."""
