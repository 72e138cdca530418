"""Launch entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.dryrun``."""
