"""Model configurations of the LM zoo: copies of ``repro.configs`` (the
dataclasses and the ten architecture data modules) with only the import
paths changed. The mesh shape sets (``repro.configs.shapes``) come with
the mesh slice."""
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig, MULTI_POD, SINGLE_POD, reduced

__all__ = [
    "MeshConfig",
    "ModelConfig",
    "ShapeConfig",
    "MULTI_POD",
    "SINGLE_POD",
    "reduced",
]
