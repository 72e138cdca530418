"""Checkpoints and predictor artifacts in the reference's on-disk format."""
from repro_torch.checkpoint.artifact import PredictorArtifact
from repro_torch.checkpoint.manager import ArtifactCorrupt, CheckpointManager

__all__ = ["ArtifactCorrupt", "CheckpointManager", "PredictorArtifact"]
