"""Elastic mesh selection — the port of ``repro.runtime.elastic``: rebuild
the (pod, data, model) mesh after node loss/gain and restart from
checkpoint with resharding restore.

The policy keeps the model axis fixed (it must divide head/ffn dims) and
absorbs device-count changes on the data/pod axes; the train driver calls
``choose_mesh`` on (re)start and the checkpoint manager reshards state onto
the new topology. Only ``build`` touches devices.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import make_mesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def choose_mesh(
    n_devices: int,
    model_axis: int = 16,
    pod_size: int = 256,
) -> MeshPlan:
    """Largest usable mesh ≤ n_devices with fixed model axis.

    Multi-pod when ≥ 2 full pods survive; otherwise a single (data, model)
    mesh over the largest multiple of model_axis.
    """
    if model_axis > n_devices:
        # degenerate small-world (tests): shrink model axis to fit
        model_axis = max(1, n_devices)
    pods = n_devices // pod_size
    if pods >= 2:
        data = pod_size // model_axis
        return MeshPlan((pods, data, model_axis), ("pod", "data", "model"))
    usable = (n_devices // model_axis) * model_axis
    data = max(usable // model_axis, 1)
    return MeshPlan((data, model_axis), ("data", "model"))


def build(plan: MeshPlan, device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(plan.shape, plan.axes, device_type)


def replan_after_failure(current: MeshPlan, lost_devices: int, model_axis: int = 16) -> MeshPlan:
    """New plan after losing devices (straggler exclusion / hardware fault)."""
    return choose_mesh(current.n_devices - lost_devices, model_axis=model_axis)
