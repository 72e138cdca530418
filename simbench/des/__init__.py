"""A frozen copy of the port's discrete-event simulator (``repro_torch.des``:
``isa``, ``workloads``, ``trace``, ``branch``, ``cache``, ``o3``), the
benchmark's own trace generator. Only the import lines differ from the
port's files; the benchmark's traffic does not move when the program's
copy changes."""
