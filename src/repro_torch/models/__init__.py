"""Model families of the LM zoo (the dense family so far)."""
from repro_torch.models.registry import build_model

__all__ = ["build_model"]
