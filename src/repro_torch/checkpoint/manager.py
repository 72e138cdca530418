"""Fault-tolerant checkpointing — the port of ``repro.checkpoint.manager``:
atomic writes, keep-N, async save thread.

Format (the reference's, byte for byte in layout): one npz per save (the
flattened tree with '/'-joined keys, ``#i`` for list and tuple items) plus
a json manifest (step, keys, the payload's sha256, user metadata), in
``step_<10 digits>/``. Either package reads what the other wrote. Leaves
may be numpy arrays or tensors on any device; they are written as numpy
arrays. ``restore`` returns numpy leaves, or tensors on ``device``; with
``shardings`` it places the listed leaves on a mesh as DTensors (elastic
restore onto another topology).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch._device import DeviceLike


class ArtifactCorrupt(RuntimeError):
    """Checkpoint payload bytes do not match the manifest's sha256.

    Typed so callers (the model registry) can isolate the corrupt artifact —
    trip its circuit breaker — without guessing from a pickle/zip error.
    """


def _write_fsync(path: Path, data: bytes) -> None:
    """Write bytes and fsync the file so the rename can't publish torn bytes."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    """fsync a directory entry (durability of renames/creates within it)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, metadata: Optional[dict] = None):
        """Atomic: write to tmp dir, fsync-rename into place, prune old."""
        flat = _flatten(tree)
        host = {k: _to_host(v) for k, v in flat.items()}
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time

        def do_save():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            # Serialize to memory first so the manifest can carry a checksum
            # of the exact bytes that hit disk.
            buf = io.BytesIO()
            np.savez(buf, **host)
            payload = buf.getvalue()
            _write_fsync(tmp / "arrays.npz", payload)
            manifest = {
                "step": step,
                "time": time.time(),
                "keys": sorted(host),
                "sha256": {"arrays.npz": hashlib.sha256(payload).hexdigest()},
                "metadata": metadata or {},
            }
            _write_fsync(
                tmp / "manifest.json", json.dumps(manifest, indent=2).encode("utf-8")
            )
            # Durability order: file contents → tmp dir entries → rename →
            # parent dir entry. A crash at any point leaves either the old
            # checkpoint or a complete new one, never a manifest over torn
            # payload bytes.
            _fsync_dir(tmp)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic on same filesystem
            _fsync_dir(self.dir)
            self._prune()

        if self.async_save:
            self._thread = threading.Thread(target=do_save, daemon=True)
            self._thread.start()
        else:
            do_save()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: Optional[int] = None) -> dict:
        """The json manifest of a checkpoint (step, keys, user metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return json.loads((self.dir / f"step_{step:010d}" / "manifest.json").read_text())

    def restore(self, step: Optional[int] = None, device: DeviceLike = None, shardings=None):
        """Load a checkpoint: (tree, step). Leaves are numpy arrays, or
        tensors on ``device`` when one is given.

        ``shardings``: a tree of ``(mesh, placements)`` leaves matching (a
        part of) the saved structure, as `runtime.sharding` gives them;
        each listed leaf becomes a DTensor placed so (every rank of the
        mesh restores the same checkpoint; the mesh or rules may differ
        from save time)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        raw = (path / "arrays.npz").read_bytes()
        # Chaos seam: a corrupt trigger flips a byte here, *before* the
        # checksum check — exercising exactly the on-disk bit-rot path.
        from repro_torch.serving import faults

        raw = faults.fire("artifact.load", payload=raw)
        want = self.read_manifest(step).get("sha256", {}).get("arrays.npz")
        if want is not None:  # pre-checksum checkpoints load unverified
            got = hashlib.sha256(raw).hexdigest()
            if got != want:
                raise ArtifactCorrupt(
                    f"{path / 'arrays.npz'}: sha256 mismatch "
                    f"(manifest {want[:12]}…, payload {got[:12]}…)"
                )
        z = np.load(io.BytesIO(raw))
        targets = {} if shardings is None else _flatten_shardings(shardings)

        def leaf(k, v):
            if k in targets:
                mesh, placements = targets[k]
                return distribute_tensor(torch.from_numpy(v).to(mesh.device_type), mesh, placements)
            return v if device is None else torch.from_numpy(v).to(device)

        return _unflatten({k: leaf(k, z[k]) for k in z.files}), step


def _flatten_shardings(tree, prefix=""):
    """`_flatten` of a tree whose leaves are ``(mesh, placements)`` pairs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_shardings(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not (len(tree) == 2 and isinstance(tree[0], DeviceMesh)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_shardings(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: tree}
