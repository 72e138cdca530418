"""PredictorArtifact: a trained SimNet predictor as a portable artifact —
the port of ``repro.checkpoint.artifact``, in the same on-disk format, so
an artifact written by either package loads in the other.

An artifact bundles everything a later process needs to reproduce a
simulation exactly:

  params    the predictor params (bit-identical across save → load)
  pcfg      the PredictorConfig the params were initialised with
  sim_cfg   the SimConfig the predictor was trained under (ctx_len etc.)
  metadata  free-form training provenance (history, errors, timings)

Storage rides `checkpoint.manager.CheckpointManager` (atomic npz + json
manifest): configs and metadata go in the manifest, params in the arrays.
``load`` brings the params to torch through
`core.predictor.params_from_numpy`, on the card unless the caller asks
for another device.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Mapping

from repro_torch._device import DeviceLike
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.predictor import PredictorConfig, params_from_numpy
from repro_torch.core.simulator import SimConfig

ARTIFACT_KIND = "simnet-predictor"
ARTIFACT_VERSION = 1


def _config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _pcfg_from_dict(d: Mapping[str, Any]) -> PredictorConfig:
    d = dict(d)
    if "channels" in d:
        d["channels"] = tuple(d["channels"])  # json round-trips tuples as lists
    return PredictorConfig(**d)


def _sim_cfg_from_dict(d: Mapping[str, Any]) -> SimConfig:
    return SimConfig(**d)


@dataclasses.dataclass(frozen=True)
class PredictorArtifact:
    params: Any
    pcfg: PredictorConfig
    sim_cfg: SimConfig
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def save(self, path) -> Path:
        """Atomically write the artifact directory (overwrites in place)."""
        mgr = CheckpointManager(path, keep=1)
        mgr.save(
            0,
            {"params": self.params},
            metadata={
                "artifact_kind": ARTIFACT_KIND,
                "artifact_version": ARTIFACT_VERSION,
                "pcfg": _config_to_dict(self.pcfg),
                "sim_cfg": _config_to_dict(self.sim_cfg),
                "metadata": dict(self.metadata),
            },
        )
        return Path(path)

    @classmethod
    def load(cls, path, device: DeviceLike = None) -> "PredictorArtifact":
        """Read an artifact; its params become the port's params on
        ``device`` (default ``cuda``)."""
        # guard before constructing the manager: its __init__ mkdirs, and a
        # read must never create directories at a mistyped path
        if not Path(path).is_dir():
            raise FileNotFoundError(f"no artifact directory at {path}")
        mgr = CheckpointManager(path)
        tree, step = mgr.restore()
        meta = mgr.read_manifest(step).get("metadata", {})
        if meta.get("artifact_kind") != ARTIFACT_KIND:
            raise ValueError(f"{path} is not a {ARTIFACT_KIND} artifact")
        pcfg = _pcfg_from_dict(meta["pcfg"])
        return cls(
            params=params_from_numpy(tree["params"], pcfg, device),
            pcfg=pcfg,
            sim_cfg=_sim_cfg_from_dict(meta["sim_cfg"]),
            metadata=meta.get("metadata", {}),
        )

    @staticmethod
    def exists(path) -> bool:
        """Pure read: probing must not create the directory."""
        manifests = sorted(
            Path(path).glob("step_*/manifest.json")
        ) if Path(path).is_dir() else []
        if not manifests:
            return False
        try:
            meta = json.loads(manifests[-1].read_text()).get("metadata", {})
        except (OSError, json.JSONDecodeError):
            return False
        return meta.get("artifact_kind") == ARTIFACT_KIND
