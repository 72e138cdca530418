"""Model configurations of the LM zoo: copies of ``repro.configs`` (the
dataclasses, the ten architecture data modules and the assigned input
shape sets of ``shapes.py``) with only the import paths changed."""
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig, MULTI_POD, SINGLE_POD, reduced
from repro_torch.configs.shapes import LONG_CONTEXT_OK, SHAPES, shape_applicable

__all__ = [
    "MeshConfig",
    "ModelConfig",
    "ShapeConfig",
    "MULTI_POD",
    "SINGLE_POD",
    "reduced",
    "SHAPES",
    "LONG_CONTEXT_OK",
    "shape_applicable",
]
