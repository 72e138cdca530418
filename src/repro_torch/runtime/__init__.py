"""Fleet-scale runtime hooks: a copy of ``repro.runtime.straggler`` (stdlib only).
The mesh, elastic and HLO modules come with the port's mesh."""
