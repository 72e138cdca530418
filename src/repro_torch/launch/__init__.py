"""Launch entry points: ``python -m repro_torch.launch.train``."""
